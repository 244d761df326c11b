"""Array operations: divergence, the detection-map kernel, geometry,
mappings, dihedral TTA, NMS and the host density sampler."""
