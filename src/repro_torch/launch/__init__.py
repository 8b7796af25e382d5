"""The launch layer: the cell grid, meshes, deploy configs and sharding
rules, the step builders and the serve / train / dry-run launchers
(PyTorch port of ``repro.launch``)."""
