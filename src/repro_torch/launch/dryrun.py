"""Multi-pod dry-run of the port: trace every (architecture x input shape)
step once at its full config on the production mesh and record what each
device would do, as the JAX package's ``repro.launch.dryrun`` records
XLA's cost and memory analysis.

The mesh is ``launch.mesh.make_production_mesh``: 16x16 (or 2x16x16) over
a fake process group of one process, whose collectives are recorded and
never run. Every tensor is a ``FakeTensorMode`` tensor, so nothing is
allocated, and the step runs eagerly on DTensors whose local tensors have
rank 0's shard shapes: tracing once takes the place of "lower + compile".
Eager tracing runs every layer, so the JAX launcher's reduced-layer probes
and their extrapolation (XLA's cost analysis counts a scanned layer body
once) have no counterpart here, and the records have no
``flops_scanned_hlo``.

Each number is per device (rank 0), counted on the local ops that the
DTensors dispatch, replicated work included:

  flops             matmul-class operations (``torch.utils.flop_counter``'s
                    formulas) on the local shapes
  bytes_accessed    inputs plus outputs of every local op that is not a view
  collective_bytes  output bytes of each ``c10d_functional`` collective on
                    the local tensors, bucketed as the JAX launcher buckets
                    HLO collectives (all-gather, all-reduce, reduce-scatter,
                    all-to-all)
  memory            argument_bytes (the local shards of the step's inputs),
                    output_bytes (of its outputs), temp_bytes (the peak of
                    live local bytes the step's ops allocated)

The step must make no host read of a device value: under fake tensors one
fails the record.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-1.7b \\
      --shape train_4k --single-pod [--opt act_shard,seq_attn]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod|--single-pod]

Records go to results/dryrun_torch/ (results/dryrun_torch_opt/ with
``--opt``), one JSON file per (arch, shape, mesh); ``--skip-done`` skips
those already ``ok`` or ``skipped``.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, get_config
from repro_torch.distributed.steps import build_dryrun, supports
from repro_torch.launch.mesh import make_production_mesh

RESULTS_DIR = pathlib.Path(__file__).resolve().parents[3] / "results" / \
    "dryrun_torch"

_COLLECTIVES = {"all_reduce": "all-reduce",
                "all_gather_into_tensor": "all-gather",
                "reduce_scatter_tensor": "reduce-scatter",
                "all_to_all_single": "all-to-all",
                "broadcast": "broadcast"}


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _local_tensors(tree):
    """The local tensors of every tensor leaf (a DTensor's shard)."""
    from torch.distributed.tensor import DTensor
    leaves, _ = tree_flatten(tree)
    return [t._local_tensor if isinstance(t, DTensor) else t
            for t in leaves if isinstance(t, torch.Tensor)]


class CostCounter(TorchDispatchMode):
    """Counts the local ops under it: an op on DTensors is passed on
    (``NotImplemented``), so DTensor dispatches it and the ops it runs on
    the local shards come back here, where they are counted. DTensor also
    runs each new op once on whole-tensor fakes to learn its output's
    shape; those runs are not the device's work and are not counted."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self.registry = flop_registry
        self.flops = 0
        self.bytes = 0
        self.collective = {}
        self.live = 0
        self.peak = 0
        self._seen = weakref.WeakKeyDictionary()
        self._meta = 0

    def __enter__(self):
        from torch.distributed.tensor._sharding_prop import \
            ShardingPropagator as SP
        self._orig = SP._propagate_tensor_meta_non_cached
        orig, counter = self._orig, self

        def propagate(prop, op_schema):
            counter._meta += 1
            try:
                return orig(prop, op_schema)
            finally:
                counter._meta -= 1

        SP._propagate_tensor_meta_non_cached = propagate
        return super().__enter__()

    def __exit__(self, *exc):
        from torch.distributed.tensor._sharding_prop import \
            ShardingPropagator as SP
        SP._propagate_tensor_meta_non_cached = self._orig
        return super().__exit__(*exc)

    def _track(self, out):
        for t in tree_flatten(out)[0]:
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            if st in self._seen:
                continue
            n = st.nbytes()
            self._seen[st] = n
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, n)

    def _free(self, n):
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if self._meta:
            return out
        packet = func.overloadpacket
        name = packet.__name__
        if func.namespace == "_c10d_functional" and name in _COLLECTIVES:
            kind = _COLLECTIVES[name]
            self.collective[kind] = self.collective.get(kind, 0) + sum(
                _nbytes(t) for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor))
            return out
        if packet in self.registry:
            self.flops += self.registry[packet](*args, **kwargs, out_val=out)
        views = any(r.alias_info is not None for r in func._schema.returns)
        if not views:
            self.bytes += sum(_nbytes(t) for t in tree_flatten(
                (args, kwargs, out))[0] if isinstance(t, torch.Tensor))
            self._track(out)
        return out


def _measure(cfg, shape, mesh, opts: frozenset = frozenset()) -> dict:
    """Trace one step at ``cfg`` x ``shape`` on ``mesh``; return its
    per-device cost terms."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode(allow_non_fake_inputs=True):
        t0 = time.time()
        fn, args = build_dryrun(cfg, shape, mesh, opts)
        counter = CostCounter()
        with counter:
            out = fn(*args)
        t1 = time.time()
        arg_bytes = sum(_nbytes(t) for t in _local_tensors(args))
        out_bytes = sum(_nbytes(t) for t in _local_tensors(out))
    return {
        "trace_s": round(t1 - t0, 1),
        "flops": float(counter.flops),
        "bytes_accessed": float(counter.bytes),
        "collective_bytes": counter.collective,
        "memory": {"argument_bytes": arg_bytes, "output_bytes": out_bytes,
                   "temp_bytes": counter.peak},
    }


def run_one(arch: str, shape_name: str, multi_pod: bool,
            opts: frozenset = frozenset()) -> dict:
    cfg = get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    rec = {"arch": arch, "shape": shape_name,
           "mesh": "2x16x16" if multi_pod else "16x16",
           "opts": sorted(opts), "ts": time.time()}
    if not supports(cfg, shape):
        rec["status"] = "skipped"
        rec["reason"] = "no sub-quadratic variant (DESIGN.md §4)"
        return rec
    mesh = make_production_mesh(multi_pod=multi_pod)
    rec.update({"status": "ok", **_measure(cfg, shape, mesh, opts)})
    return rec


def _results_dir(opts: frozenset) -> pathlib.Path:
    return RESULTS_DIR if not opts else RESULTS_DIR.parent / \
        "dryrun_torch_opt"


def load_results(opts: frozenset = frozenset()) -> list:
    d = _results_dir(opts)
    if not d.exists():
        return []
    return [json.loads(p.read_text()) for p in sorted(d.glob("*.json"))]


def save_result(rec: dict, opts: frozenset = frozenset()) -> pathlib.Path:
    d = _results_dir(opts)
    d.mkdir(parents=True, exist_ok=True)
    name = f"{rec['arch']}__{rec['shape']}__{rec['mesh'].replace('x','-')}.json"
    (d / name).write_text(json.dumps(rec, indent=1))
    return d / name


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(INPUT_SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--single-pod", action="store_true")
    ap.add_argument("--skip-done", action="store_true")
    ap.add_argument("--opt", default="",
                    help="comma list: act_shard,seq_attn,moe_ep,kv_seq_shard "
                         "(results land in dryrun_torch_opt/)")
    args = ap.parse_args(argv)
    opts = frozenset(o for o in args.opt.split(",") if o)

    meshes = []
    if args.single_pod or not args.multi_pod:
        meshes.append(False)
    if args.multi_pod or not args.single_pod:
        meshes.append(True)

    if args.all:
        combos = [(a, s) for a in ARCH_IDS for s in INPUT_SHAPES]
    else:
        if not (args.arch and args.shape):
            raise SystemExit("--arch/--shape or --all")
        combos = [(args.arch, args.shape)]

    done = {(r["arch"], r["shape"], r["mesh"]) for r in load_results(opts)
            if r.get("status") in ("ok", "skipped")} if args.skip_done else set()

    failures = 0
    for arch, shape in combos:
        for mp in meshes:
            mesh_name = "2x16x16" if mp else "16x16"
            if (arch, shape, mesh_name) in done:
                continue
            t0 = time.time()
            try:
                rec = run_one(arch, shape, mp, opts)
            except Exception as e:  # noqa: BLE001
                rec = {"arch": arch, "shape": shape, "mesh": mesh_name,
                       "opts": sorted(opts), "status": "error",
                       "error": f"{type(e).__name__}: {e}"[:2000],
                       "trace": traceback.format_exc()[-2000:]}
                failures += 1
            rec["wall_s"] = round(time.time() - t0, 2)
            path = save_result(rec, opts)
            msg = rec["status"]
            if rec["status"] == "ok":
                msg += (f" flops={rec['flops']:.4e} "
                        f"coll={sum(rec['collective_bytes'].values()):.4e}B "
                        f"args={rec['memory']['argument_bytes']:.4e}B "
                        f"trace={rec['trace_s']}s")
            elif rec["status"] == "error":
                msg += f" {rec['error'][:300]}"
            print(f"[dryrun] {arch} x {shape} x {mesh_name}: {msg}",
                  flush=True)
            print(f"[dryrun-record] {path}", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
