"""JAX's and the port's quality training side by side on the CPU.

Both packages' ``run_one`` train branches (``scripts/quality_evidence.py``
and ``scripts/torch_quality_evidence.py``, ``--skip-opt``) run on one cut
of the suite, each in its own directory: each builds the suite and writes
its DUFO labels, trains ``seflowpp`` (the network cut to ``overrides``)
and writes its flow with ``fleet_save``, then evaluates. The port starts
from JAX's initial weights (``utils/convert.flax_to_torch``), every train
step is logged, and the witness returns both runs' losses step by step,
their validations, both tables, and whether the two suites and their
labels are bitwise equal. ``tests/test_torch_scripts.py`` runs it at a
toy size; run alone, it takes a larger cut:

    python3 tests/torch_quality_witness.py [--scenes 6] [--adv 2] [--epochs 6] \\
        [--voxel 0.8] [--depths 32,64,128] [--work DIR] [--save-init FILE]

It prints one line a step (the losses and their largest relative
difference), one a validation metric, the tables, and a JSON summary as
its last line. JAX runs without x64, as the quality runs of the JAX
package do. On a GPU host, which has no JAX, ``--card FILE --against DIR``
runs the port alone on the GPU from the initial weights that
``--save-init`` saved, and holds it step by step to the CPU runs in
``DIR`` (the CPU witness's ``--work``, its ``jax/`` and ``port/``).
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import importlib.util
import json
import os
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402

SSL_KEYS = ("ssl_dynamic", "ssl_cluster", "ssl_prior", "ssl_prior_valid")
COMPARED = ("CDE", "MPE", "EPE_3way", "EPE_FD", "EPE_BS", "AccS", "AccR")


def _script(name: str):
    spec = importlib.util.spec_from_file_location(name, REPO / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@contextlib.contextmanager
def _patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def _every_step(cls):
    """``cls(**kwargs)`` with ``log_every=1``, whatever the caller passes."""
    return lambda **kwargs: cls(**{**kwargs, "log_every": 1})


def _metrics(run_dir: Path) -> dict:
    """``{"train": {step: loss}, "val": {step: {metric: value}}}`` from a
    run's ``metrics.jsonl``."""
    out = {"train": {}, "val": {}}
    for line in (run_dir / "metrics.jsonl").read_text().splitlines():
        rec = json.loads(line)
        step = int(rec["step"])
        train = {k[6:]: v for k, v in rec.items() if k.startswith("train/")}
        val = {k[4:]: v for k, v in rec.items() if k.startswith("val/")}
        if train:
            out["train"][step] = train
        if val:
            out["val"][step] = val
    return out


def _suites_equal(a: Path, b: Path) -> dict:
    """Whether the two suites' scene files hold bitwise the same datasets,
    apart from the labels, and whether their labels are equal."""
    import h5py

    names = sorted(p.name for p in a.glob("scene_*.h5"))
    data = labels = names == sorted(p.name for p in b.glob("scene_*.h5"))
    for name in names if data else ():
        with h5py.File(a / name, "r") as fa, h5py.File(b / name, "r") as fb:
            for g in fa:
                for d in fa[g]:
                    va = np.asarray(fa[g][d][()])
                    vb = np.asarray(fb[g][d][()]) if d in fb.get(g, {}) else None
                    same = vb is not None and va.dtype == vb.dtype and \
                        va.tobytes() == vb.tobytes()
                    if d in SSL_KEYS:
                        labels &= same
                    elif not d.startswith("runs") and d not in ("seflowpp",):
                        data &= same
    return {"data": bool(data), "labels": bool(labels)}


def _modules(side: str):
    """``(synthetic, feedforward, trainer)`` of the side's package."""
    if side == "jax":
        from himo_tpu.data import synthetic
        from himo_tpu.models import feedforward
        from himo_tpu.training import trainer
    else:
        from himo_tpu_torch.data import synthetic
        from himo_tpu_torch.models import feedforward
        from himo_tpu_torch.training import trainer
    return synthetic, feedforward, trainer


def run_side(work: Path, side: str, suite: dict, overrides: dict, flags: list,
             state=None) -> dict:
    """One package's ``run_one`` train branch in ``work/side``: the suite cut
    to ``suite``, the network to ``overrides``, every step logged. The port
    (any side but ``"jax"``) starts from the state dict ``state``; the JAX
    side returns its initial weights converted to one, under ``"state"``.
    Writes the table to ``work/side/table.json``."""
    syn, ff, tr = _modules(side)
    port_qe = _script("torch_quality_evidence")
    module = _script("quality_evidence") if side == "jax" else port_qe
    inits, init_params = [], ff.init_params

    def jax_init(*args, **kwargs):
        inits.append(init_params(*args, **kwargs))
        return inits[-1]

    def port_init(model, generator):
        model.load_state_dict(state)
        return state

    cwd = os.getcwd()
    try:
        with contextlib.ExitStack() as stack:
            stack.enter_context(_patched(syn, "make_benchmark_dataset", functools.partial(
                syn.make_benchmark_dataset, **suite)))
            for target in (ff, tr):
                stack.enter_context(_patched(target, "make_model",
                                             functools.partial(ff.make_model, **overrides)))
            stack.enter_context(_patched(tr, "TrainConfig", _every_step(tr.TrainConfig)))
            if side == "jax":
                stack.enter_context(_patched(ff, "init_params", jax_init))
            else:
                stack.enter_context(_patched(tr, "init_params", port_init))
            (work / side).mkdir(parents=True, exist_ok=True)
            os.chdir(work / side)
            args = port_qe.parse_args(["--root", str(work / side / "av2_quality"),
                                       "--skip-opt", *flags])
            table = module.run_one(args, work / side / "av2_quality", 0)
    finally:
        os.chdir(cwd)
    (work / side / "table.json").write_text(json.dumps(table, indent=1))
    out = {"table": table}
    if side == "jax":
        import jax

        from himo_tpu_torch.models import feedforward as PF
        from himo_tpu_torch.utils.convert import flax_to_torch

        _, config = PF.make_model("seflowpp", device="cpu", **overrides)
        out["state"] = flax_to_torch(jax.tree_util.tree_map(np.asarray, inits[-1]), config)
    return out


def compare(dirs: dict, echo=print) -> dict:
    """Step by step over the runs in ``dirs`` (side -> its directory, the
    first side the one the others are held to): each train step's total
    loss, each validation's metrics and each table's cells. Returns
    ``{"steps": [(step, loss a side...)], "val": [(step, metric, value a
    side...)], "tables": {side: table}, "max_rel_loss": {side: x}}``."""
    sides = list(dirs)
    runs = {s: _metrics(Path(d) / "av2_quality" / "runs" / "seflowpp") for s, d in dirs.items()}
    tables = {s: json.loads((Path(d) / "table.json").read_text()) for s, d in dirs.items()}
    common = sorted(set.intersection(*(set(r["train"]) for r in runs.values())))
    steps = [(k, *(runs[s]["train"][k]["total"] for s in sides)) for k in common]
    val_steps = sorted(set.intersection(*(set(r["val"]) for r in runs.values())))
    val = [(k, m, *(runs[s]["val"][k][m] for s in sides))
           for k in val_steps for m in sorted(runs[sides[0]]["val"][k])]
    head = "  ".join(f"{s:>10s}" for s in sides)
    echo(f"step  train total {head}  max rel to {sides[0]}")
    for k, ref, *rest in steps:
        rel = max((abs(v - ref) / max(abs(ref), 1e-12) for v in rest), default=0.0)
        echo(f"{k:4d}  {'':11s} " + "  ".join(f"{v:10.6f}" for v in (ref, *rest)) +
             f"  {rel:.2e}")
    for k, m, *values in val:
        echo(f"val {k:4d} {m:<10s} " + "  ".join(f"{v:10.6f}" for v in values))
    for m in tables[sides[0]]:
        echo(f"{m:<16s} " + "  ".join(
            f"{c} " + "/".join(f"{tables[s][m][c]:.4f}" for s in sides) for c in COMPARED))
    max_rel = {s: max((abs(runs[s]["train"][k]["total"] - runs[sides[0]]["train"][k]["total"])
                       / max(abs(runs[sides[0]]["train"][k]["total"]), 1e-12)
                       for k in common), default=None) for s in sides[1:]}
    return {"steps": steps, "val": val, "tables": tables, "max_rel_loss": max_rel,
            "train_steps": {s: len(r["train"]) for s, r in runs.items()}}


def witness(work: Path, suite: dict, overrides: dict, flags: list, echo=print,
            save_init=None) -> dict:
    """JAX's run and the port's from JAX's initial weights, both on the CPU,
    in ``work/jax`` and ``work/port``; :func:`compare`'s result, with
    ``"suites"``: whether the two suites and their labels are bitwise
    equal. ``save_init``, where given, is where the initial state dict is
    saved (``torch.save``) for a run of the port elsewhere."""
    import torch

    jax_out = run_side(work, "jax", suite, overrides, flags)
    if save_init is not None:
        torch.save(jax_out["state"], save_init)
    run_side(work, "port", suite, overrides, flags, state=jax_out["state"])
    out = compare({"jax": work / "jax", "port": work / "port"}, echo)
    out["suites"] = _suites_equal(work / "jax" / "av2_quality", work / "port" / "av2_quality")
    echo(f"suites bitwise equal: data {out['suites']['data']}, "
         f"labels {out['suites']['labels']}")
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenes", type=int, default=6)
    ap.add_argument("--adv", type=int, default=2)
    ap.add_argument("--epochs", type=int, default=6)
    ap.add_argument("--voxel", type=float, default=0.8)
    ap.add_argument("--depths", default="32,64,128")
    ap.add_argument("--num-points", type=int, default=20480)
    ap.add_argument("--bg-points", type=int, default=16000)
    ap.add_argument("--obj-points", type=int, default=400)
    ap.add_argument("--work", default=None,
                    help="the runs' directory (default: a new one under the temporary dir)")
    ap.add_argument("--save-init", default=None,
                    help="also save the initial state dict here (torch.save)")
    ap.add_argument("--card", default=None, metavar="INIT",
                    help="run the port alone on the GPU from this saved state dict, and "
                    "hold it to the CPU runs in --against (no JAX is imported)")
    ap.add_argument("--against", default=None,
                    help="a CPU witness's --work directory (its jax/ and port/ runs)")
    args = ap.parse_args(argv)
    work = Path(args.work or tempfile.mkdtemp(prefix="quality_witness_"))
    suite = dict(num_scenes=args.scenes, adversarial_scenes=args.adv)
    overrides = {"pillar.voxel_size": (args.voxel, args.voxel),
                 "depths": tuple(int(d) for d in args.depths.split(","))}
    flags = ["--epochs", str(args.epochs), "--num-points", str(args.num_points),
             "--bg-points", str(args.bg_points), "--obj-points", str(args.obj_points)]
    if args.card:
        import torch

        state = torch.load(args.card, map_location="cpu")
        run_side(work, "card", suite, overrides, [*flags, "--device", "cuda"], state=state)
        against = Path(args.against)
        out = compare({"jax": against / "jax", "port": against / "port", "card": work / "card"})
    else:
        import jax

        jax.config.update("jax_platforms", "cpu")
        out = witness(work, suite, overrides, [*flags, "--device", "cpu"],
                      save_init=args.save_init)
    summary = {"work": str(work), "steps": len(out["steps"]), "max_rel_loss": out["max_rel_loss"],
               "mpe": {s: {m: t[m]["MPE"] for m in t} for s, t in out["tables"].items()},
               "suites": out.get("suites")}
    print(json.dumps(summary))
    return out


if __name__ == "__main__":
    main()
