"""Partition plans: the ``getAllPartitions`` abstraction (the port's
copy of the JAX package's ``repro.partition.base``, host numpy only).

A partitioner maps every incidence edge to a partition id (the paper's
extended GraphX interface returns exactly this RDD).  From that assignment
we derive:

* padded, equally-shaped per-partition edge shards (every rank of the
  ``data`` mesh axis runs the same shapes, so the collectives line up —
  padding edges carry ``mask=0`` and reduce to the combiner identity), and
* the stats the paper's evaluation turns on: replication factors, load
  balance, and projected per-superstep collective bytes.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class PartitionStats:
    n_parts: int
    edge_balance: float          # max shard / mean shard (1.0 = perfect)
    vertex_replication: float    # avg #partitions holding a vertex replica
    hyperedge_replication: float
    pad_fraction: float          # wasted lanes from static-shape padding
    # projected bytes moved per superstep per float32 of entity state:
    #   sync cost of every replica beyond the master copy, both directions.
    sync_bytes_per_dim: float
    # the per-side replica surplus behind sync_bytes_per_dim (number of
    # extra entity copies the cut created); kept separate so consumers
    # can weight each side by its actual state width in bytes
    # (select_backend folds attribute widths in — wide hyperedge state
    # must not be priced like a scalar vertex rank).
    v_extra_replicas: float = 0.0
    he_extra_replicas: float = 0.0

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    def sync_bytes(
        self, v_state_bytes: float = 4.0, he_state_bytes: float = 4.0
    ) -> float:
        """Projected per-superstep sync volume with each side weighted
        by its state width (bytes per entity); the historical
        ``sync_bytes_per_dim`` is the 4-byte-uniform special case."""
        return 2.0 * (
            v_state_bytes * self.v_extra_replicas
            + he_state_bytes * self.he_extra_replicas
        )


@dataclasses.dataclass
class PartitionPlan:
    """Edge->partition assignment plus padded shards."""

    name: str
    n_parts: int
    edge_part: np.ndarray        # [nnz] int32
    # padded shards, shape [n_parts, shard_len]:
    shard_src: np.ndarray
    shard_dst: np.ndarray
    shard_mask: np.ndarray       # float32 {0,1}
    stats: PartitionStats
    partition_time_s: float = 0.0

    @property
    def shard_len(self) -> int:
        return int(self.shard_src.shape[1])


def _replication(entity_ids: np.ndarray, parts: np.ndarray, n: int) -> float:
    """Average number of distinct partitions touching each entity."""
    if len(entity_ids) == 0 or n == 0:
        return 0.0
    key = entity_ids.astype(np.int64) * np.int64(2**20) + parts.astype(np.int64)
    distinct = len(np.unique(key))
    present = len(np.unique(entity_ids))
    return distinct / max(present, 1)


def build_plan(
    name: str,
    src: np.ndarray,
    dst: np.ndarray,
    n_vertices: int,
    n_hyperedges: int,
    edge_part: np.ndarray,
    n_parts: int,
    pad_multiple: int = 8,
    partition_time_s: float = 0.0,
) -> PartitionPlan:
    nnz = len(src)
    counts = np.bincount(edge_part, minlength=n_parts)
    shard_len = int(counts.max()) if nnz else pad_multiple
    shard_len = -(-shard_len // pad_multiple) * pad_multiple

    shard_src = np.zeros((n_parts, shard_len), np.int32)
    shard_dst = np.zeros((n_parts, shard_len), np.int32)
    shard_mask = np.zeros((n_parts, shard_len), np.float32)
    order = np.argsort(edge_part, kind="stable")
    s_sorted, d_sorted = src[order], dst[order]
    offsets = np.zeros(n_parts + 1, np.int64)
    np.cumsum(counts, out=offsets[1:])
    for p in range(n_parts):
        lo, hi = offsets[p], offsets[p + 1]
        k = hi - lo
        shard_src[p, :k] = s_sorted[lo:hi]
        shard_dst[p, :k] = d_sorted[lo:hi]
        shard_mask[p, :k] = 1.0

    v_rep = _replication(src, edge_part, n_vertices)
    he_rep = _replication(dst, edge_part, n_hyperedges)
    mean_load = max(counts.mean(), 1e-9)
    # Sync model (paper §IV-B): every replica beyond the first must be
    # refreshed (gather) and its partial aggregate merged back (scatter)
    # once per superstep -> 2 transfers x 4 bytes per state dim.
    n_v_present = len(np.unique(src)) if nnz else 0
    n_he_present = len(np.unique(dst)) if nnz else 0
    v_extra = max((v_rep - 1.0) * n_v_present, 0.0)
    he_extra = max((he_rep - 1.0) * n_he_present, 0.0)
    stats = PartitionStats(
        n_parts=n_parts,
        edge_balance=float(counts.max() / mean_load) if nnz else 1.0,
        vertex_replication=float(v_rep),
        hyperedge_replication=float(he_rep),
        pad_fraction=float(1.0 - nnz / (n_parts * shard_len)),
        sync_bytes_per_dim=float(2 * 4 * (v_extra + he_extra)),
        v_extra_replicas=float(v_extra),
        he_extra_replicas=float(he_extra),
    )
    return PartitionPlan(
        name=name,
        n_parts=n_parts,
        edge_part=edge_part.astype(np.int32),
        shard_src=shard_src,
        shard_dst=shard_dst,
        shard_mask=shard_mask,
        stats=stats,
        partition_time_s=partition_time_s,
    )
