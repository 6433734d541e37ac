#!/usr/bin/env python3
"""The (dp, tp) train step across GPUs, one rank a GPU (NCCL), against one GPU.

    python3 scripts/train_ranks_torch.py [MESH ...]

MESH picks the meshes to run, among ``tp`` (dp x tp), ``pp``, ``cp`` and
``ep``; all four when none is named (one GPU's references run only for the
meshes chosen).

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
  calls and bytes;
- context parallelism (``make_cp_train_step``) on cp = 4, the same f32 run
  with the sequence cut 128 tokens a rank, ZeRO-1 over cp: against one
  GPU's f32 run under the same gates, with the ring's p2p calls and bytes;
- expert parallelism (``make_ep_train_step``) on (dp, ep) = (2, 2):
  Mixtral-8x7B widths (chip_smoke.py's MIXTRAL_HF) cut to 2 MoE layers,
  f32, adamw(1e-4), ZeRO-1 over dp, 4 experts a rank, 3 steps of the same
  batch shape, against one GPU's dense-and-mask make_train_step with
  grad_accum 2, whose microbatches are the dp ranks' rows, under the same
  gates, with the ep line's collectives. The same rows matter: 2048 rows
  at once and two halves of 1024 take other cuBLAS kernels, and that
  rounding alone flips a router choice of layer 1 tied within 1.5e-8 in
  the dense route itself, which Adam's sign-like first steps spread over
  the chosen experts' leaves (updates 1.2e-01 apart after 3 steps).

Prints the card's name and power limit, each rank's transport, the
collectives' calls and bytes on each axis, step ms and tokens/s on both
routes, and the peak memory of a rank. Needs four GPUs (a 2 x 2 mesh);
exits 1 with fewer.
"""

from __future__ import annotations

import gc
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402

BATCH, SEQ, STEPS, SEED = 4, 512, 3, 41
MESHES = ("tp", "pp", "cp", "ep")
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


def train_cp(torch):
    """STEPS f32 steps on a cp = 4 mesh: losses, step seconds, the whole
    params by name (every rank), the peak bytes, the ring's p2p [calls,
    bytes] and the mesh."""
    from shardmerge_tpu_torch.parallel.mesh import make_mesh
    from shardmerge_tpu_torch.parallel.train import make_cp_train_step, tree_flatten

    mesh = make_mesh(("cp",), shape=(4,))
    cfg = cs.train_cfg()
    gen = torch.Generator(device=mesh.device).manual_seed(SEED)
    batch = torch.randint(0, cfg.vocab_size, (BATCH, SEQ + 1), device=mesh.device, generator=gen)
    params = init(torch, cfg, "f32", mesh.device)
    init_state, step = make_cp_train_step(mesh, cfg, params, learning_rate=cs.TRAIN_LR, zero1=True)
    torch.cuda.reset_peak_memory_stats()
    state = init_state(params)
    del params
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
    return losses, walls, whole, peak, mesh.comm("cp").stats.get("p2p", [0, 0])[:2], mesh


EP_LAYERS = 2  # the ep mesh's MoE layers


def moe_cfg():
    from shardmerge_tpu_torch.models import llama

    return llama.ModelConfig.from_hf_config({**cs.MIXTRAL_HF, "num_hidden_layers": EP_LAYERS})


def list_names(whole: dict) -> dict:
    """Stacked experts' leaves under the expert lists' names."""
    out = {}
    for name, v in whole.items():
        parts = name.split("/")
        if "experts_stacked" in parts:
            for e in range(v.shape[0]):
                out[f"layers/{parts[1]}/experts/{e}/{('w1', 'w3', 'w2')[int(parts[3])]}"] = v[e]
        else:
            out[name] = v
    return out


def train_ep(torch):
    """STEPS f32 Mixtral-width steps on a (dp, ep) = (2, 2) mesh: losses, step
    seconds, the whole params by name (experts joined over ep), the peak
    bytes, the ep line's collectives [calls, bytes] and the mesh."""
    from shardmerge_tpu_torch.models import llama
    from shardmerge_tpu_torch.parallel.mesh import make_mesh
    from shardmerge_tpu_torch.parallel.moe import make_ep_train_step
    from shardmerge_tpu_torch.parallel.train import tree_flatten

    mesh = make_mesh(("dp", "ep"), shape=(2, 2))
    cfg = moe_cfg()
    gen = torch.Generator(device=mesh.device).manual_seed(SEED)
    batch = torch.randint(0, cfg.vocab_size, (BATCH, SEQ + 1), device=mesh.device, generator=gen)
    params = llama.init_params(cfg, seed=SEED, dtype=torch.float32, device=mesh.device)
    llama.stack_expert_weights(params)
    init_state, step = make_ep_train_step(mesh, cfg, params, learning_rate=cs.TRAIN_LR, zero1=True)
    torch.cuda.reset_peak_memory_stats()
    state = init_state(params)
    del params
    torch.cuda.empty_cache()
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
    ep = mesh.comm("ep")
    return losses, walls, list_names(whole), peak, {k: v[:2] for k, v in ep.stats.items()}, mesh


def train_moe_one(torch):
    """STEPS f32 Mixtral-width steps on one GPU, the expert lists
    dense-and-mask, grad_accum 2 (the dp ranks' rows a microbatch): losses,
    step seconds, the whole params and the initial ones by name (on the
    host), the peak bytes."""
    from shardmerge_tpu_torch.models import llama
    from shardmerge_tpu_torch.parallel.mesh import Mesh
    from shardmerge_tpu_torch.parallel.train import make_train_step, tree_flatten

    cfg = moe_cfg()
    dev = "cuda:0"
    gen = torch.Generator(device=dev).manual_seed(SEED)
    batch = torch.randint(0, cfg.vocab_size, (BATCH, SEQ + 1), device=dev, generator=gen)
    params = llama.init_params(cfg, seed=SEED, dtype=torch.float32, device=dev)
    paths, leaves = tree_flatten(params)
    names = ["/".join(map(str, p)) for p in paths]
    p0 = {n: v.cpu() for n, v in zip(names, leaves)}
    init_state, step = make_train_step(Mesh(("dp", "tp"), (1, 1), 0, dev), cfg, learning_rate=cs.TRAIN_LR,
                                       grad_accum=2)
    torch.cuda.reset_peak_memory_stats()
    state = init_state(params)
    del params, leaves
    losses, walls = [], []
    for _ in range(STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, loss = step(state, batch)
        losses.append(float(loss))
        walls.append(time.perf_counter() - t0)
    whole = {n: v.cpu() for n, v in zip(names, tree_flatten(state["params"])[1])}
    peak = torch.cuda.max_memory_allocated()
    del state
    torch.cuda.empty_cache()
    return losses, walls, whole, p0, peak


def rank_main(root: Path, chosen) -> int:
    import torch

    from shardmerge_tpu_torch.parallel.mesh import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh(("dp", "tp"))
    out = {"device": str(mesh.device), "shape": mesh.shape,
           "transport": {a: c.transport for a, c in mesh.comms.items()}}
    for kind in RECIPES if "tp" in chosen else ():
        for c in mesh.comms.values():
            c.stats.clear()
        losses, walls, whole, peak = train(torch, mesh, kind, zero1=True)
        out[kind] = {"losses": losses, "step_ms": [w * 1e3 for w in walls], "peak": peak,
                     "collectives": {a: {k: v[:2] for k, v in c.stats.items()} for a, c in mesh.comms.items()}}
        if mesh.rank == 0:
            torch.save(whole, root / f"ranks_{kind}.pt")
        del whole
    for tag, (axes, shape) in PP_MESHES.items() if "pp" in chosen else ():
        losses, walls, whole, peak, p2p, m = train_pp(torch, axes, shape)
        out[tag] = {"losses": losses, "step_ms": [w * 1e3 for w in walls], "peak": peak, "p2p": p2p,
                    "coords": m.coords, "transport": m.comm("pp").transport}
        if m.coords.get("dp", 0) == 0 and m.coords.get("tp", 0) == 0:  # this stage's leaves, whole
            torch.save(whole, root / f"pp_{tag.replace(' ', '')}_{m.coords['pp']}.pt")
        del whole
    for tag, key, fn in (("cp", "cp", train_cp), ("dp x ep", "ep", train_ep)):
        if key not in chosen:
            continue
        losses, walls, whole, peak, comms, m = fn(torch)
        out[tag] = {"losses": losses, "step_ms": [w * 1e3 for w in walls], "peak": peak, "comms": comms,
                    "transport": next(iter(m.comms.values())).transport}
        if m.rank == 0:
            torch.save(whole, root / f"{tag.replace(' ', '')}.pt")
        del whole
    (root / f"rank{mesh.rank}.json").write_text(json.dumps(out))
    return 0


def main(chosen) -> int:
    import torch

    from shardmerge_tpu_torch.parallel.mesh import Mesh
    from shardmerge_tpu_torch.parallel.train import tree_flatten

    if set(chosen) - set(MESHES):
        print(f"train_ranks_torch: meshes are {MESHES}, not {sorted(set(chosen) - set(MESHES))}", file=sys.stderr)
        return 2
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
        # one GPU's references: every recipe for dp x tp, f32 for pp and cp
        kinds = RECIPES + (EXACT,) if "tp" in chosen else ("f32",) if {"pp", "cp"} & set(chosen) else ()
        for kind in kinds:
            losses, walls, whole, peak = train(torch, Mesh(("dp", "tp"), (1, 1), 0, "cuda:0"), kind, zero1=False)
            one[kind] = (losses, walls, whole)
            step = sorted(walls)[1]
            cs.say(f"[one GPU] {kind}: losses {[round(x, 5) for x in losses]}; step {step * 1e3:.1f} ms "
                   f"({BATCH * SEQ / step:.0f} tokens/s; steps {[round(w * 1e3, 1) for w in walls]}), peak "
                   f"{peak / 2**30:.2f} GiB")

        cfg = cs.train_cfg()
        p0 = {kind: [v.float().cpu() for v in tree_flatten(init(torch, cfg, kind, "cuda:0"))[1]]
              for kind in RECIPES if kind in kinds}
        logs = root / "logs"
        gc.collect()
        torch.cuda.empty_cache()  # rank 0 shares GPU 0 with this process
        cs.say(f"[one GPU] this process holds {torch.cuda.memory_reserved() / 2**30:.2f} GiB of GPU 0 while the "
               f"ranks run")
        t0 = time.perf_counter()
        # a rank that fails makes the others' collectives time out in 180 s, not NCCL's 10 minutes
        proc = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", str(gpus), "--log-dir", str(logs),
             "--redirects", "3", str(Path(__file__).resolve()), "--rank", str(root), *chosen],
            cwd=cs.REPO, capture_output=True, text=True, timeout=1500,
            env={**os.environ, "SHARDMERGE_HEARTBEAT_TIMEOUT_S": "180"})
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            tails = "".join(f"\n--- {p.relative_to(logs)}:\n{p.read_text()[-3000:]}"
                            for p in sorted(logs.rglob("*.log")))
            raise SystemExit(f"torchrun exited {proc.returncode}:\n{proc.stderr[-3000:]}{tails}")
        ranks = [json.loads((root / f"rank{r}.json").read_text()) for r in range(gpus)]
        r0 = ranks[0]
        if "ep" in chosen:
            moe_losses, moe_walls, moe_whole, moe_p0, moe_peak = train_moe_one(torch)  # the GPUs are free again
            cs.say(f"[one GPU] Mixtral-8x7B widths x {EP_LAYERS} layers, f32, dense-and-mask, grad_accum 2: losses "
                   f"{[round(x, 5) for x in moe_losses]}; step {sorted(moe_walls)[1] * 1e3:.1f} ms; peak "
                   f"{moe_peak / 2**30:.2f} GiB")
        cs.say(f"[ranks] {gpus} ranks on a {r0['shape']} mesh: {[(r['device'], r['transport']) for r in ranks]}; "
               f"torchrun wall {wall:.1f} s")
        ok = True
        for kind in RECIPES if "tp" in chosen else ():
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
        ref_losses, ref_walls, ref_whole = one.get("f32", (None, None, []))
        ref = dict(zip(names, ref_whole))
        start = dict(zip(names, p0.get("f32", [])))
        for tag, (axes, shape) in PP_MESHES.items() if "pp" in chosen else ():
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
        checks = {"cp": lambda: (ref_losses, ref_walls, ref, start, "the ring's p2p [calls, bytes] over the steps "
                                                                     "by rank"),
                  "dp x ep": lambda: (moe_losses, moe_walls, moe_whole, moe_p0, "the ep line's collectives [calls, "
                                                                                "bytes] over the steps by rank")}
        for tag in [t for t in checks if t[-2:] in chosen]:
            ref_l, ref_w, ref_whole, start_whole, what = checks[tag]()
            whole = torch.load(root / f"{tag.replace(' ', '')}.pt")
            mine = r0[tag]
            keys = sorted(ref_whole)
            rel = max(abs(a - b) / abs(b) for a, b in zip(mine["losses"], ref_l))
            upd = update_gap([whole[n] for n in keys], [ref_whole[n] for n in keys], [start_whole[n] for n in keys])
            passed = sorted(whole) == keys and rel <= 1e-4 and upd <= 1e-2
            ok &= passed
            step = sorted(mine["step_ms"])[1]
            cs.say(f"[ranks] {tag} ({mine['transport']}), f32, ZeRO-1: losses {[round(x, 5) for x in mine['losses']]}, "
                   f"losses rel to one GPU {rel:.2e} (gate 1e-4), params' updates relL2 {upd:.2e} (gate 1e-2); step "
                   f"{step:.1f} ms ({BATCH * SEQ / step * 1e3:.0f} tokens/s) vs one GPU {sorted(ref_w)[1] * 1e3:.1f} "
                   f"ms; {what} {[r[tag]['comms'] for r in ranks]}; peak "
                   f"{max(r[tag]['peak'] for r in ranks) / 2**30:.2f} "
                   f"GiB a rank {'ok' if passed else 'FAIL'}")
        if not ok:
            raise SystemExit("[ranks] a sharded step left one GPU's class")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    cs.say(card)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        sys.exit(rank_main(Path(sys.argv[2]), sys.argv[3:]))
    sys.exit(main(sys.argv[1:] or list(MESHES)))
