"""Array operations: divergence, the detection-map kernel, geometry,
mappings, dihedral TTA and NMS."""
