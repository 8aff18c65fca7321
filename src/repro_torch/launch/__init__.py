"""Launch layer of the port: ``repro_torch.launch.hypergraph`` runs the
built-in algorithms through the ``Engine`` facade (``--devices N``: N
ranks over ``repro_torch.launch.mesh``'s process group and mesh)."""
