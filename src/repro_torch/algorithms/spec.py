"""AlgorithmSpec: one definition, every engine.

Each algorithm module builds a spec (initial state + programs + design
metadata); the ``Engine`` facade (``repro_torch.core.executor``) runs it.

Serving metadata feeds ``Engine.compile`` (``repro_torch.core.serving``):
``init`` rebuilds initial attributes on a new structure; ``bind_query``
binds one request's varying state, such as an SSSP source, on the host
(it may read the query with ``int``), once per query of a batch; it
may touch only ``v_attr`` / ``he_attr``.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

from repro_torch.core.api import Program
from repro_torch.core.hypergraph import HyperGraph


class AlgorithmSpec(NamedTuple):
    """A runnable algorithm: state + programs + design-choice metadata.

    * ``name`` labels results / reports.
    * ``touches_hyperedge_state``: True when the algorithm reads or
      returns per-hyperedge state — clique expansion (constant folding,
      §IV-A1) is only legal when False.
    * ``clique_program``: optional equivalent computation over the
      clique-expanded graph.
    * ``init``: ``(hg) -> hg0_unbound``, rebuild initial attributes.
    * ``bind_query``: ``(hg0_unbound, query) -> hg0``.
    * ``query0``: the query baked into ``hg0``, or ``None``.
    """

    hg0: HyperGraph
    initial_msg: Any
    v_program: Program
    he_program: Program
    max_iters: int
    extract: Callable[[HyperGraph], Any]
    name: str = "custom"
    touches_hyperedge_state: bool = True
    clique_program: Callable[..., Any] | None = None
    init: Callable[[HyperGraph], HyperGraph] | None = None
    bind_query: Callable[[HyperGraph, Any], HyperGraph] | None = None
    query0: Any = None


def resolve_engine(engine=None):
    """The algorithm wrappers' engine policy: the caller's engine, or a
    fresh default one (on the card)."""
    if engine is not None:
        return engine
    from repro_torch.core.executor import Engine

    return Engine()
