"""MESH: a flexible distributed hypergraph processing system — the
PyTorch/CUDA port.

Each ``repro_torch/<path>.py`` is the counterpart of ``repro/<path>.py``
(the JAX package, which stays the reference).  The port imports
``torch``, ``numpy`` and the standard library only.  Its entry points
run on the card unless the caller passes ``device="cpu"``.

    >>> from repro_torch.core import Engine
    >>> from repro_torch.data import make_dataset
    >>> from repro_torch.algorithms import pagerank_spec
    >>> hg = make_dataset("dblp", 1.0, seed=0)          # on the card
    >>> Engine().run(pagerank_spec(hg, iters=30)).value
"""
