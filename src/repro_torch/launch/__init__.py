"""Launch layer of the port: ``repro_torch.launch.hypergraph`` runs the
built-in algorithms through the ``Engine`` facade."""
