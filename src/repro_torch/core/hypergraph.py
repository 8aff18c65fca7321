"""The HyperGraph structure: bipartite incidence representation.

A hypergraph H=(V,E) is stored as MESH stores it inside GraphX: a
bipartite incidence list with low-level edges directed vertex ->
hyperedge.  ``src[i]`` is a vertex id, ``dst[i]`` a hyperedge id (int32
tensors, as in the JAX package); attribute trees hang off each side with
leading dims ``n_vertices`` / ``n_hyperedges``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core.api import tree_map
from repro_torch.core.device import resolve_device

Pytree = Any


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


@dataclasses.dataclass
class HyperGraph:
    """Bipartite incidence representation of a hypergraph.

    Attributes:
      src: ``[nnz]`` int32 vertex id per incidence.
      dst: ``[nnz]`` int32 hyperedge id per incidence.
      n_vertices / n_hyperedges: sizes.
      v_attr / he_attr: attribute trees (leading dim = entity count).
      e_attr: optional per-incidence attribute tree (leading dim nnz).
      e_mask: optional ``[nnz]`` float mask (1=live).  Padding incidences
        carry 0 and contribute the combiner identity.
    """

    src: torch.Tensor
    dst: torch.Tensor
    n_vertices: int
    n_hyperedges: int
    v_attr: Pytree = None
    he_attr: Pytree = None
    e_attr: Pytree = None
    e_mask: torch.Tensor | None = None

    # -- constructors -------------------------------------------------------
    @classmethod
    def from_hyperedge_lists(
        cls,
        hyperedges: list[list[int]],
        n_vertices: int | None = None,
        v_attr: Pytree = None,
        he_attr: Pytree = None,
        device=None,
    ) -> "HyperGraph":
        """Build from a python list of member lists (tests / tiny inputs)."""
        src = np.concatenate(
            [np.asarray(m, dtype=np.int32) for m in hyperedges]
        ) if hyperedges else np.zeros(0, np.int32)
        dst = np.concatenate(
            [np.full(len(m), i, dtype=np.int32)
             for i, m in enumerate(hyperedges)]
        ) if hyperedges else np.zeros(0, np.int32)
        nv = n_vertices if n_vertices is not None else (
            int(src.max()) + 1 if len(src) else 0
        )
        return cls.from_coo(src, dst, nv, len(hyperedges), v_attr=v_attr,
                            he_attr=he_attr, device=device)

    @classmethod
    def from_coo(
        cls,
        src,
        dst,
        n_vertices: int,
        n_hyperedges: int,
        device=None,
        **kw,
    ) -> "HyperGraph":
        dev = resolve_device(device)
        return cls(
            src=torch.as_tensor(_host(src).astype(np.int32), device=dev),
            dst=torch.as_tensor(_host(dst).astype(np.int32), device=dev),
            n_vertices=int(n_vertices),
            n_hyperedges=int(n_hyperedges),
            **kw,
        )

    @classmethod
    def from_numpy(
        cls,
        src,
        dst,
        n_v: int,
        n_e: int,
        v_attr: Pytree = None,
        he_attr: Pytree = None,
        e_attr: Pytree = None,
        e_mask=None,
        device=None,
    ) -> "HyperGraph":
        """Carry a hypergraph over from host arrays: every field goes
        through ``np.asarray`` (so any array type that converts — a JAX
        array included — is accepted) onto ``device``."""
        dev = resolve_device(device)
        # np.array copies: arrays carried over may be read-only buffers.
        conv = lambda a, dt=None: torch.as_tensor(np.array(a, dtype=dt),
                                                  device=dev)
        return cls(
            src=conv(src, np.int32),
            dst=conv(dst, np.int32),
            n_vertices=int(n_v),
            n_hyperedges=int(n_e),
            v_attr=tree_map(conv, v_attr),
            he_attr=tree_map(conv, he_attr),
            e_attr=tree_map(conv, e_attr),
            e_mask=conv(e_mask) if e_mask is not None else None,
        )

    # -- basic queries --------------------------------------------------------
    @property
    def device(self) -> torch.device:
        return self.src.device

    @property
    def nnz(self) -> int:
        return int(self.src.shape[0])

    def _incidence_weights(self) -> torch.Tensor:
        if self.e_mask is not None:
            return self.e_mask.to(torch.int32)
        return torch.ones_like(self.src)

    def degrees(self) -> torch.Tensor:
        """Vertex degree: number of hyperedges each vertex belongs to."""
        out = torch.zeros(self.n_vertices, dtype=torch.int32,
                          device=self.device)
        return out.index_add_(0, self.src, self._incidence_weights())

    def cardinalities(self) -> torch.Tensor:
        """Hyperedge cardinality: number of member vertices."""
        out = torch.zeros(self.n_hyperedges, dtype=torch.int32,
                          device=self.device)
        return out.index_add_(0, self.dst, self._incidence_weights())

    # -- transformations (GraphX-style structural ops) ------------------------
    def map_vertices(self, fn: Callable[[torch.Tensor, Pytree], Pytree]):
        ids = torch.arange(self.n_vertices, dtype=torch.int32,
                           device=self.device)
        return dataclasses.replace(self, v_attr=fn(ids, self.v_attr))

    def map_hyperedges(self, fn: Callable[[torch.Tensor, Pytree], Pytree]):
        ids = torch.arange(self.n_hyperedges, dtype=torch.int32,
                           device=self.device)
        return dataclasses.replace(self, he_attr=fn(ids, self.he_attr))

    def with_attrs(self, v_attr: Pytree = None, he_attr: Pytree = None):
        return dataclasses.replace(
            self,
            v_attr=v_attr if v_attr is not None else self.v_attr,
            he_attr=he_attr if he_attr is not None else self.he_attr,
        )

    def sub_hypergraph(
        self,
        v_pred: np.ndarray | None = None,
        he_pred: np.ndarray | None = None,
    ) -> "HyperGraph":
        """Host-side structural subsetting (preprocessing).

        Keeps ids stable; drops incidences touching excluded entities
        (GraphX ``subgraph`` semantics: excluded entities keep their slot
        but lose connectivity).
        """
        src = _host(self.src)
        dst = _host(self.dst)
        keep = np.ones(len(src), dtype=bool)
        if self.e_mask is not None:
            # Padding incidences (mask 0) are dead: they must not be
            # resurrected as live rows of the sub-hypergraph.
            keep &= _host(self.e_mask) != 0
        if v_pred is not None:
            keep &= _host(v_pred).astype(bool)[src]
        if he_pred is not None:
            keep &= _host(he_pred).astype(bool)[dst]
        keep_t = torch.as_tensor(keep, device=self.device)
        return dataclasses.replace(
            self,
            src=self.src[keep_t],
            dst=self.dst[keep_t],
            e_attr=tree_map(lambda a: a[keep_t], self.e_attr),
            e_mask=None,
        )

    def padded(self, nv_pad: int, ne_pad: int, nnz_pad: int) -> "HyperGraph":
        """Pad structure and attributes to the given bucket dims.

        Padding incidences carry ``e_mask=0`` and reference entity 0;
        padded entity slots are zero-filled and unreachable.  The mask is
        ALWAYS materialized, even when ``nnz_pad == nnz``.
        """
        if (nv_pad < self.n_vertices or ne_pad < self.n_hyperedges
                or nnz_pad < self.nnz):
            raise ValueError(
                f"padded dims ({nv_pad}, {ne_pad}, {nnz_pad}) must cover "
                f"({self.n_vertices}, {self.n_hyperedges}, {self.nnz})"
            )

        def pad_rows(x, n):
            if n == x.shape[0]:
                return x
            pad = torch.zeros((n - x.shape[0],) + tuple(x.shape[1:]),
                              dtype=x.dtype, device=x.device)
            return torch.cat([x, pad])

        mask = (
            self.e_mask.to(torch.float32)
            if self.e_mask is not None
            else torch.ones(self.nnz, dtype=torch.float32, device=self.device)
        )
        return HyperGraph(
            src=pad_rows(self.src, nnz_pad),
            dst=pad_rows(self.dst, nnz_pad),
            n_vertices=nv_pad,
            n_hyperedges=ne_pad,
            v_attr=tree_map(lambda a: pad_rows(a, nv_pad), self.v_attr),
            he_attr=tree_map(lambda a: pad_rows(a, ne_pad), self.he_attr),
            e_attr=tree_map(lambda a: pad_rows(a, nnz_pad), self.e_attr),
            e_mask=pad_rows(mask, nnz_pad),
        )

    def sorted_by_dst(self) -> "HyperGraph":
        """An equivalent hypergraph with incidences sorted by hyperedge
        id (stable: ties keep incidence order)."""
        order = torch.sort(self.dst, stable=True).indices
        take = lambda a: a.index_select(0, order)
        return dataclasses.replace(
            self,
            src=take(self.src),
            dst=take(self.dst),
            e_attr=tree_map(take, self.e_attr),
            e_mask=take(self.e_mask) if self.e_mask is not None else None,
        )

    def validate(self) -> None:
        src = _host(self.src)
        dst = _host(self.dst)
        if len(src) != len(dst):
            raise ValueError("src/dst length mismatch")
        if len(src) and (src.min() < 0 or src.max() >= self.n_vertices):
            raise ValueError("vertex id out of range")
        if len(dst) and (dst.min() < 0 or dst.max() >= self.n_hyperedges):
            raise ValueError("hyperedge id out of range")
