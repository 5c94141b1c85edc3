"""The mesh path (port of `repro.sharding`): the reference's partition
rules (`specs`), parameters laid out over a mesh (`placement`) and the
collectives between the mesh's entries (`comm`)."""
