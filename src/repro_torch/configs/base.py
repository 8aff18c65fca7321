"""Config schema: ArchSpec = model config + its assigned shape set, the
counterpart of the JAX package's ``repro.configs.base`` (the same
classes and shape sets).

Every architecture gets one module defining ``CONFIG`` (its published
hyperparameters) and ``smoke()`` (a reduced same-family config for CPU
tests).  The launcher resolves ``--arch <id>`` to a model config.
"""
from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One input-shape cell of the (arch x shape) grid."""

    name: str
    kind: str  # train | prefill | decode | graph_train | recsys_train |
               # recsys_serve | recsys_retrieval
    dims: dict[str, int]
    skip: str | None = None  # reason if this cell is skipped (documented)


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str                       # lm | gnn | recsys
    model: Any                        # LMConfig | GATConfig | ...
    shapes: dict[str, ShapeSpec]
    source: str = ""                  # provenance tag from the assignment
    notes: str = ""

    def shape(self, name: str) -> ShapeSpec:
        return self.shapes[name]


# ---- assigned LM shape set (identical for the 5 LM archs) ----------------

def lm_shapes(*, long_skip: str | None,
              train_accum: int = 8) -> dict[str, ShapeSpec]:
    return {
        "train_4k": ShapeSpec(
            "train_4k", "train",
            # accum_steps = gradient accumulation (microbatch = global /
            # accum): the memory-fit knob, chosen per arch by the JAX
            # package for its own training step.
            {"seq_len": 4096, "global_batch": 256,
             "accum_steps": train_accum},
        ),
        "prefill_32k": ShapeSpec(
            "prefill_32k", "prefill",
            {"seq_len": 32768, "global_batch": 32},
        ),
        "decode_32k": ShapeSpec(
            "decode_32k", "decode",
            {"seq_len": 32768, "global_batch": 128},
        ),
        "long_500k": ShapeSpec(
            "long_500k", "decode",
            {"seq_len": 524288, "global_batch": 1},
            skip=long_skip,
        ),
    }


GNN_SHAPES = {
    "full_graph_sm": ShapeSpec(
        "full_graph_sm", "graph_train",
        {"n_nodes": 2708, "n_edges": 10556, "d_feat": 1433,
         "n_classes": 7},
    ),
    "minibatch_lg": ShapeSpec(
        "minibatch_lg", "graph_train",
        # reddit-scale host graph; the device step sees the sampled block
        {"n_nodes": 232_965, "n_edges": 114_615_892, "batch_nodes": 1024,
         "fanout0": 15, "fanout1": 10, "d_feat": 602, "n_classes": 41},
    ),
    "ogb_products": ShapeSpec(
        "ogb_products", "graph_train",
        {"n_nodes": 2_449_029, "n_edges": 61_859_140, "d_feat": 100,
         "n_classes": 47},
    ),
    "molecule": ShapeSpec(
        "molecule", "graph_train",
        {"n_nodes": 30, "n_edges": 64, "batch": 128, "d_feat": 16,
         "n_classes": 8},
    ),
}


RECSYS_SHAPES = {
    "train_batch": ShapeSpec(
        "train_batch", "recsys_train", {"batch": 65_536}
    ),
    "serve_p99": ShapeSpec(
        "serve_p99", "recsys_serve", {"batch": 512}
    ),
    "serve_bulk": ShapeSpec(
        "serve_bulk", "recsys_serve", {"batch": 262_144}
    ),
    "retrieval_cand": ShapeSpec(
        "retrieval_cand", "recsys_retrieval",
        {"batch": 1, "n_candidates": 1_000_000},
    ),
}
