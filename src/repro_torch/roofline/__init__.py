"""Roofline model at the H100's published rates, over the reference's
dry-run record format: HLO collective parsing (``hlo``), the three
roofline terms per cell (``model``) and the table CLI (``report``)."""
