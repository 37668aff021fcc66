"""Bipartite graph sources (seeded generators and a KONECT parser)."""
