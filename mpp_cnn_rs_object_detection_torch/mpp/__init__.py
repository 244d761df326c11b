"""The marked point process: state, energies, combiners, proposal data,
the cell-parallel sampler and exact whole-scene inference."""
