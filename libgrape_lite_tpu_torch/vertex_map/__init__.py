"""oid <-> gid directory: partitioners, idxers, vertex map."""
