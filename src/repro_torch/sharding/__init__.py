"""Mesh-shape-only sharding rules over the port's ``DeviceMesh``: the
counterpart of the reference's ``repro.sharding``."""
