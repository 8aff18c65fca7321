"""Digest-stability audit: ``stable_digest`` against cache poisoning (the
port's counterpart of the JAX package's ``repro.analysis.digest``).

The disk store (``serve/cache.py``) re-keys the in-memory executable
signature (``core/serving.py``'s ``signature``, object-identity based)
into a cross-process ``stable_digest``, under which it keeps a
signature's warmup record.  Three invariants make that safe, and this
pass checks each over a real grid of spec / design point / bucket
combinations:

* **identity** — rebuilding the same spec from scratch (fresh function
  objects, fresh tensors) digests identically: object identity must not
  leak in, or a new process never finds its records;
* **collision-freedom** — semantically distinct signatures (algorithm,
  bucket pads, attribute dtypes, query axis, batch pad, design point,
  the fused layouts' ``delivery_sig``, the distributed ``n_parts`` /
  ``shard_len_pad``) all digest differently: a collision silently hands
  one signature's record to another;
* **cross-process determinism** — a child interpreter (fresh
  ``PYTHONHASHSEED``, fresh object addresses) computes the same digest
  per grid point: hash randomization and ``repr`` addresses must not
  reach the hash.

``grid_digests`` is the child-process entry point (imported by the
subprocess the audit spawns).  Everything here is host work on the CPU.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

from repro_torch.analysis.findings import Finding


def build_grid() -> list[tuple[str, object]]:
    """(name, signature-tuple) per grid point — every point is built
    through the REAL key path (``serving.signature`` over real specs,
    configs, attribute and query signatures and fused layouts), and
    names describe what makes each point distinct."""
    import numpy as np
    import torch

    from repro_torch.algorithms import (
        label_propagation_spec,
        pagerank_spec,
        shortest_paths_spec,
    )
    from repro_torch.core import serving
    from repro_torch.core.executor import ExecutionConfig
    from repro_torch.data import powerlaw_hypergraph
    from repro_torch.kernels.deliver import layout_pair

    cpu = torch.device("cpu")
    hg = powerlaw_hypergraph(47, 33, mean_cardinality=4, seed=0, device=cpu)
    specs = {
        "pagerank": pagerank_spec(hg, iters=6),
        "sssp": shortest_paths_spec(hg, 0, 12),
        "labelprop": label_propagation_spec(hg, iters=6),
    }
    hgp = hg.padded(64, 64, serving.bucket_dim(hg.nnz))

    def attr_sigs(spec):
        p = spec.hg0.padded(64, 64, serving.bucket_dim(hg.nnz))
        return dict(v_attr_sig=serving._attr_sig(p.v_attr),
                    he_attr_sig=serving._attr_sig(p.he_attr),
                    e_attr_sig=serving._attr_sig(p.e_attr))

    base = dict(shard_len_pad=0, n_parts=0, query_sig=None,
                batch_pad=None, delivery_sig=None)
    dist = {"local": (0, 0), "replicated": (4, 64), "sharded": (4, 64)}
    grid: list[tuple[str, object]] = []
    for sname, spec in specs.items():
        for backend, (n_parts, shard_len_pad) in dist.items():
            for nv_pad, ne_pad, nnz_pad in ((64, 64, 256), (128, 64, 512)):
                for batch_pad in (None, 8):
                    cfg = ExecutionConfig(backend=backend, delivery="xla")
                    name = (f"{sname}/{backend}/pads={nv_pad}-{ne_pad}-"
                            f"{nnz_pad}/b={batch_pad}")
                    grid.append((name, serving.signature(
                        spec, cfg, nv_pad=nv_pad, ne_pad=ne_pad,
                        nnz_pad=nnz_pad,
                        **{**base, **attr_sigs(spec), "batch_pad": batch_pad,
                           "n_parts": n_parts,
                           "shard_len_pad": shard_len_pad},
                    )))
    # design-point, dtype, query-axis and layout variants on one point
    spec = specs["sssp"]
    cfg = ExecutionConfig(backend="local", delivery="xla")
    pads = dict(nv_pad=64, ne_pad=64, nnz_pad=256)
    base.update(attr_sigs(spec))
    fused = ExecutionConfig(backend="local", delivery="pallas_fused")

    def sig(name, spec=spec, cfg=cfg, **over):
        grid.append((name, serving.signature(spec, cfg, **pads,
                                             **{**base, **over})))

    sig("sssp/stats", cfg=ExecutionConfig(backend="local", delivery="xla",
                                          collect_stats=True))
    sig("sssp/max_iters=5", cfg=ExecutionConfig(backend="local",
                                                delivery="xla", max_iters=5))
    skewed = powerlaw_hypergraph(47, 33, mean_cardinality=4,
                                 popularity_alpha=1.2, seed=3, device=cpu)
    for label, other in (("uniform", hgp), ("skewed", skewed.padded(
            64, 64, serving.bucket_dim(skewed.nnz)))):
        lay = layout_pair(other.src, other.dst, other.e_mask,
                          other.n_vertices, other.n_hyperedges)
        sig(f"sssp/delivery=pallas_fused/{label}", cfg=fused,
            delivery_sig=tuple(x.shape_signature() for x in lay))
    sig("sssp/query=int32", query_sig=serving._query_sig(
        serving._canon_query(3)))
    sig("sssp/query=float32", query_sig=serving._query_sig(
        serving._canon_query(np.float32(3.0))))
    sig("sssp/query=int32/b=8", batch_pad=8, query_sig=serving._query_sig(
        serving._canon_query(3)))
    for dt in (torch.float32, torch.float64):
        sig(f"sssp/eattr={dt}", e_attr_sig=serving._attr_sig(
            torch.zeros(hgp.nnz, dtype=dt)))
    sig("sssp/vattr=f64", v_attr_sig=serving._attr_sig(
        spec.hg0.v_attr.to(torch.float64)))
    sig("sssp/initmsg0", spec=spec._replace(
        initial_msg=torch.tensor(0.0)))
    sig("sssp/sharded/n_parts=2", cfg=ExecutionConfig(
        backend="sharded", delivery="xla"), n_parts=2, shard_len_pad=64)
    sig("sssp/sharded/shard_len_pad=128", cfg=ExecutionConfig(
        backend="sharded", delivery="xla"), n_parts=4, shard_len_pad=128)
    return grid


def grid_digests(digest_fn=None) -> dict[str, str]:
    """name -> stable_digest over the grid (the child-process entry)."""
    from repro_torch.serve.cache import stable_digest

    fn = digest_fn or stable_digest
    return {name: fn(key) for name, key in build_grid()}


_CHILD = (
    "import json, sys; from repro_torch.analysis.digest import "
    "grid_digests; json.dump(grid_digests(), sys.stdout)"
)


def audit(digest_fn=None, *, cross_process: bool = True) -> list[Finding]:
    """Run all three digest invariants; a non-default ``digest_fn`` is
    the mutation hook the negative tests use (it skips the subprocess,
    which could not import the injected function)."""
    findings: list[Finding] = []
    first = grid_digests(digest_fn)
    second = grid_digests(digest_fn)  # fresh specs, fresh closures

    for name, d in first.items():
        if second[name] != d:
            findings.append(Finding(
                rule="digest-identity", path="<digest-audit>", line=0,
                scope=name,
                message=("rebuilding the spec changed its digest "
                         f"({d[:12]} -> {second[name][:12]})"),
            ))

    by_digest: dict[str, str] = {}
    for name, d in first.items():
        if d in by_digest:
            findings.append(Finding(
                rule="digest-collision", path="<digest-audit>", line=0,
                scope=name,
                message=(f"collides with `{by_digest[d]}` "
                         f"(digest {d[:12]})"),
            ))
        else:
            by_digest[d] = name

    if cross_process and digest_fn is None:
        env = {**os.environ, "PYTHONHASHSEED": "random"}
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (_src_dir(), env.get("PYTHONPATH")) if p
        )
        out = subprocess.run(
            [sys.executable, "-c", _CHILD], env=env,
            capture_output=True, text=True, timeout=300,
        )
        if out.returncode != 0:
            findings.append(Finding(
                rule="digest-unstable", path="<digest-audit>", line=0,
                scope="<subprocess>",
                message=f"child audit failed: {out.stderr[-300:]}",
            ))
            return findings
        child = json.loads(out.stdout)
        for name, d in first.items():
            if child.get(name) != d:
                findings.append(Finding(
                    rule="digest-unstable", path="<digest-audit>", line=0,
                    scope=name,
                    message=("digest differs across processes "
                             f"({d[:12]} vs "
                             f"{str(child.get(name))[:12]})"),
                ))
    return findings


def _src_dir() -> str:
    import repro_torch

    return os.path.dirname(os.path.dirname(os.path.abspath(
        repro_torch.__file__
    )))
