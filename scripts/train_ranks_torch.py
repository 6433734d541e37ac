#!/usr/bin/env python3
"""The (dp, tp) train step across GPUs, one rank a GPU (NCCL), against one GPU.

    python3 scripts/train_ranks_torch.py

Llama-3.1-8B widths (chip_smoke.py's config) cut to 2 layers, seeded random
weights built on every GPU alike, a repeated batch of B x T = 4 x 512:

- f32 params, adamw(1e-3), 3 steps: on one GPU, then ``torchrun
  --nproc-per-node G`` over the G visible GPUs on the (dp, tp) mesh that
  ``mesh_shape_for(G, 2)`` gives (2 x 2 on four), with ZeRO-1: the losses
  within 1e-4 relative of one GPU's and each leaf's update within relL2
  1e-2;
- the bf16 recipe of chip_smoke.py's [train] (f32 master, remat, two
  microbatches, the clip + cosine chain, ZeRO-1), 3 steps on both routes:
  losses within 1e-2 relative, and the masters' updates no further from
  the same recipe run in f32 on one GPU (from the bf16 init's values) than
  twice the one-GPU bf16 run's distance from it: bf16's own rounding, which
  Adam's normalisation amplifies where a gradient is near zero, sets the
  class.

- the pipeline (``make_pp_train_step``) on (dp, pp) = (2, 2) and (pp, tp) =
  (2, 2), f32, adamw(1e-4), 2 microbatches, 3 steps: the stages' whole
  params joined by name against one GPU's f32 run under the same gates
  (losses 1e-4, updates relL2 1e-2), with each stage's point-to-point
  calls and bytes.

Prints the card's name and power limit, each rank's transport, the
collectives' calls and bytes on each axis, step ms and tokens/s on both
routes, and the peak memory of a rank. Needs four GPUs (a 2 x 2 mesh);
exits 1 with fewer.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402

BATCH, SEQ, STEPS, SEED = 4, 512, 3, 41
RECIPES = ("f32", "bf16")
# the pipeline's meshes (axes, shape) and its microbatches
PP_MESHES = {"dp x pp": (("dp", "pp"), (2, 2)), "pp x tp": (("pp", "tp"), (2, 2))}
PP_MICRO = 2
# on one GPU only: the bf16 recipe's options on f32 params that start at the
# bf16 init's values, the yardstick of the bf16 runs' rounding
EXACT = "bf16 recipe in f32"


def recipe(kind: str):
    """(params dtype, make_train_step options)."""
    import torch

    if kind == "f32":
        return torch.float32, {"learning_rate": cs.TRAIN_LR}
    opts = {"master_fp32": True, "remat": True, "grad_accum": 2, "tx": cs.train_tx()}
    return (torch.float32 if kind == EXACT else torch.bfloat16), opts


def init(torch, cfg, kind: str, device):
    """The seeded params of ``kind`` (EXACT: the bf16 init's values in f32)."""
    from shardmerge_tpu_torch.models import llama
    from shardmerge_tpu_torch.parallel.train import tree_flatten, tree_unflatten

    if kind != EXACT:
        return llama.init_params(cfg, seed=SEED, dtype=recipe(kind)[0], device=device)
    params = llama.init_params(cfg, seed=SEED, dtype=torch.bfloat16, device=device)
    return tree_unflatten(params, [v.float() for v in tree_flatten(params)[1]])


def update_gap(whole, ref, p0) -> float:
    """The largest relL2 over the leaves between two runs' updates from p0."""
    gap = 0.0
    for w, r, p in zip(whole, ref, p0):
        d = r.float() - p
        if bool((d != 0).any()):
            gap = max(gap, float(((w.float() - p) - d).norm() / d.norm()))
    return gap


def train(torch, mesh, kind: str, zero1: bool):
    """STEPS steps of ``kind`` on ``mesh``: losses, step seconds, the whole
    params (f32 runs) or masters (bf16 runs) on the host, the peak bytes."""
    from shardmerge_tpu_torch.parallel.train import make_train_step, tree_flatten

    cfg = cs.train_cfg()
    _, opts = recipe(kind)
    gen = torch.Generator(device=mesh.device).manual_seed(SEED)
    batch = torch.randint(0, cfg.vocab_size, (BATCH, SEQ + 1), device=mesh.device, generator=gen)
    init_state, step = make_train_step(mesh, cfg, zero1=zero1, **opts)
    torch.cuda.reset_peak_memory_stats()
    state = init_state(init(torch, cfg, kind, mesh.device))
    losses, walls = [], []
    for _ in range(STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, loss = step(state, batch)
        losses.append(float(loss))
        walls.append(time.perf_counter() - t0)
    lay = state.layout
    if kind == "f32":
        whole = [lay.gather("trained", i, v).cpu() for i, v in enumerate(tree_flatten(state["params"])[1])]
    else:
        whole = [lay.gather("opt", i, v).cpu() for i, v in enumerate(state["master"])]
    peak = torch.cuda.max_memory_allocated()
    del state
    torch.cuda.empty_cache()
    return losses, walls, whole, peak


def train_pp(torch, axes, shape):
    """STEPS f32 pipeline steps on a fresh ``axes`` mesh of ``shape``:
    losses, step seconds, this stage's whole params by name (on the host),
    the peak bytes, the pp line's p2p [calls, bytes] and the mesh."""
    from shardmerge_tpu_torch.parallel.mesh import make_mesh
    from shardmerge_tpu_torch.parallel.pipeline import stack_stages
    from shardmerge_tpu_torch.parallel.train import make_pp_train_step, tree_flatten

    mesh = make_mesh(axes, shape=shape)
    cfg = cs.train_cfg()
    gen = torch.Generator(device=mesh.device).manual_seed(SEED)
    batch = torch.randint(0, cfg.vocab_size, (BATCH, SEQ + 1), device=mesh.device, generator=gen)
    init_state, step = make_pp_train_step(mesh, cfg, PP_MICRO, learning_rate=cs.TRAIN_LR)
    torch.cuda.reset_peak_memory_stats()
    state = init_state(stack_stages(mesh, init(torch, cfg, "f32", mesh.device), mesh.shape["pp"],
                                    tp="tp" in axes, cfg=cfg))
    losses, walls = [], []
    for _ in range(STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, loss = step(state, batch)
        losses.append(float(loss))
        walls.append(time.perf_counter() - t0)
    lay = state.layout
    whole = {"/".join(map(str, p)): lay.gather("trained", i, v).cpu()
             for i, (p, v) in enumerate(zip(lay.paths, tree_flatten(state["params"])[1]))}
    peak = torch.cuda.max_memory_allocated()
    del state
    torch.cuda.empty_cache()
    return losses, walls, whole, peak, mesh.comm("pp").stats.get("p2p", [0, 0])[:2], mesh


def rank_main(root: Path) -> int:
    import torch

    from shardmerge_tpu_torch.parallel.mesh import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh(("dp", "tp"))
    out = {"device": str(mesh.device), "shape": mesh.shape,
           "transport": {a: c.transport for a, c in mesh.comms.items()}}
    for kind in RECIPES:
        for c in mesh.comms.values():
            c.stats.clear()
        losses, walls, whole, peak = train(torch, mesh, kind, zero1=True)
        out[kind] = {"losses": losses, "step_ms": [w * 1e3 for w in walls], "peak": peak,
                     "collectives": {a: {k: v[:2] for k, v in c.stats.items()} for a, c in mesh.comms.items()}}
        if mesh.rank == 0:
            torch.save(whole, root / f"ranks_{kind}.pt")
        del whole
    for tag, (axes, shape) in PP_MESHES.items():
        losses, walls, whole, peak, p2p, m = train_pp(torch, axes, shape)
        out[tag] = {"losses": losses, "step_ms": [w * 1e3 for w in walls], "peak": peak, "p2p": p2p,
                    "coords": m.coords, "transport": m.comm("pp").transport}
        if m.coords.get("dp", 0) == 0 and m.coords.get("tp", 0) == 0:  # this stage's leaves, whole
            torch.save(whole, root / f"pp_{tag.replace(' ', '')}_{m.coords['pp']}.pt")
        del whole
    (root / f"rank{mesh.rank}.json").write_text(json.dumps(out))
    return 0


def main() -> int:
    import torch

    from shardmerge_tpu_torch.parallel.mesh import Mesh
    from shardmerge_tpu_torch.parallel.train import tree_flatten

    gpus = torch.cuda.device_count()
    if gpus < 4:
        print(f"train_ranks_torch: {gpus} GPU(s) visible; a 2 x 2 mesh needs 4", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    cs.say(f"[card] {card} x {gpus}; torch {torch.__version__} cuda {torch.version.cuda}")
    root = Path(tempfile.mkdtemp(prefix="train_ranks_"))
    try:
        one = {}
        for kind in RECIPES + (EXACT,):
            losses, walls, whole, peak = train(torch, Mesh(("dp", "tp"), (1, 1), 0, "cuda:0"), kind, zero1=False)
            one[kind] = (losses, walls, whole)
            step = sorted(walls)[1]
            cs.say(f"[one GPU] {kind}: losses {[round(x, 5) for x in losses]}; step {step * 1e3:.1f} ms "
                   f"({BATCH * SEQ / step:.0f} tokens/s; steps {[round(w * 1e3, 1) for w in walls]}), peak "
                   f"{peak / 2**30:.2f} GiB")
        cfg = cs.train_cfg()
        p0 = {kind: [v.float().cpu() for v in tree_flatten(init(torch, cfg, kind, "cuda:0"))[1]]
              for kind in RECIPES}
        logs = root / "logs"
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", str(gpus), "--log-dir", str(logs),
             "--redirects", "3", str(Path(__file__).resolve()), "--rank", str(root)],
            cwd=cs.REPO, capture_output=True, text=True, timeout=1500)
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            tails = "".join(f"\n--- {p.relative_to(logs)}:\n{p.read_text()[-3000:]}"
                            for p in sorted(logs.rglob("*.log")))
            raise SystemExit(f"torchrun exited {proc.returncode}:\n{proc.stderr[-3000:]}{tails}")
        ranks = [json.loads((root / f"rank{r}.json").read_text()) for r in range(gpus)]
        r0 = ranks[0]
        cs.say(f"[ranks] {gpus} ranks on a {r0['shape']} mesh: {[(r['device'], r['transport']) for r in ranks]}; "
               f"torchrun wall {wall:.1f} s")
        ok = True
        for kind in RECIPES:
            ref_losses, ref_walls, ref_whole = one[kind]
            mine = r0[kind]
            whole = torch.load(root / f"ranks_{kind}.pt")
            rel = max(abs(a - b) / abs(b) for a, b in zip(mine["losses"], ref_losses))
            upd = update_gap(whole, ref_whole, p0[kind])
            if kind == "f32":
                passed = rel <= 1e-4 and upd <= 1e-2
                gates = f"losses rel to one GPU {rel:.2e} (gate 1e-4), params' updates relL2 {upd:.2e} (gate 1e-2)"
            else:  # bf16: the masters' distance from the recipe in f32, one GPU's and the ranks'
                exact = one[EXACT][2]
                e_one = update_gap(ref_whole, exact, p0[kind])
                e_ranks = update_gap(whole, exact, p0[kind])
                passed = rel <= 1e-2 and e_ranks <= 2 * e_one
                gates = (f"losses rel to one GPU {rel:.2e} (gate 1e-2), masters' updates relL2 {upd:.2e} from one "
                         f"GPU's; from the recipe in f32: ranks {e_ranks:.2e}, one GPU {e_one:.2e} (gate: ranks "
                         f"<= 2 x one GPU)")
            ok &= passed
            step = sorted(mine["step_ms"])[1]
            cs.say(f"[ranks] {kind}, ZeRO-1: losses {[round(x, 5) for x in mine['losses']]}, {gates}; step "
                   f"{step:.1f} ms "
                   f"({BATCH * SEQ / step * 1e3:.0f} tokens/s) vs one GPU {sorted(ref_walls)[1] * 1e3:.1f} ms; peak "
                   f"{max(r[kind]['peak'] for r in ranks) / 2**30:.2f} GiB a rank; collectives [calls, bytes] "
                   f"{mine['collectives']} {'ok' if passed else 'FAIL'}")
        names = ["/".join(map(str, p)) for p in tree_flatten(init(torch, cfg, "f32", "cuda:0"))[0]]
        ref_losses, ref_walls, ref_whole = one["f32"]
        ref = dict(zip(names, ref_whole))
        start = dict(zip(names, p0["f32"]))
        for tag, (axes, shape) in PP_MESHES.items():
            whole = {}
            for q in range(shape[axes.index("pp")]):
                whole.update(torch.load(root / f"pp_{tag.replace(' ', '')}_{q}.pt"))
            mine = r0[tag]
            rel = max(abs(a - b) / abs(b) for a, b in zip(mine["losses"], ref_losses))
            upd = update_gap([whole[n] for n in names], [ref[n] for n in names], [start[n] for n in names])
            passed = sorted(whole) == sorted(names) and rel <= 1e-4 and upd <= 1e-2
            ok &= passed
            step = sorted(mine["step_ms"])[1]
            cs.say(f"[ranks] pipeline {tag} {shape} ({mine['transport']}), f32, {PP_MICRO} microbatches: losses "
                   f"{[round(x, 5) for x in mine['losses']]}, losses rel to one GPU {rel:.2e} (gate 1e-4), params' "
                   f"updates relL2 {upd:.2e} (gate 1e-2); step {step:.1f} ms ({BATCH * SEQ / step * 1e3:.0f} "
                   f"tokens/s) vs one GPU {sorted(ref_walls)[1] * 1e3:.1f} ms; p2p [calls, bytes] over {STEPS} steps "
                   f"by rank {[r[tag]['p2p'] for r in ranks]}; peak {max(r[tag]['peak'] for r in ranks) / 2**30:.2f} "
                   f"GiB a rank {'ok' if passed else 'FAIL'}")
        if not ok:
            raise SystemExit("[ranks] a sharded step left one GPU's class")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    cs.say(card)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        sys.exit(rank_main(Path(sys.argv[2])))
    sys.exit(main())
