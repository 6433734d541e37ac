#!/usr/bin/env python
"""The training recipe of examples/train_recipe.py on the PyTorch port,
across the ranks a launcher starts:

    torchrun --nproc-per-node 2 examples/train_recipe_torch.py --device cpu
    torchrun --nproc-per-node 4 examples/train_recipe_torch.py            # one GPU a rank (NCCL)

On a (dp, tp) mesh over the ranks (parallel/mesh.py; dp x tp from
``mesh_shape_for``), a tiny Llama trains with:

- bf16 params and an f32 master (``master_fp32``), ZeRO-1 moments and
  master over dp (``zero1``), two microbatches a step (``grad_accum``) and
  block recompute (``remat``);
- global-norm clipping and a cosine schedule (parallel/optim.py ``chain``);
- a checkpoint after two steps, restored onto the TRANSPOSED mesh, which
  replays the same batches: its losses are the uninterrupted run's;
- a QLoRA finale: the trained model frozen at int8, rank-4 adapters trained
  on top and written as a PEFT adapter (``fuse-lora`` reads it).

Rank 0 prints a line a step and, last, one JSON summary.
"""

import argparse
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cpu, or a card (the default when one is there)")
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--out", default="train_recipe_out", help="checkpoint and adapter directory")
    args = ap.parse_args()

    import numpy as np
    import torch

    from shardmerge_tpu_torch.models import quant
    from shardmerge_tpu_torch.models.llama import QUANTIZABLE, ModelConfig, init_params
    from shardmerge_tpu_torch.parallel import optim
    from shardmerge_tpu_torch.parallel.checkpoint import restore_train_state, save_train_state
    from shardmerge_tpu_torch.parallel.lora import lora_to_peft, make_lora_train_step
    from shardmerge_tpu_torch.parallel.mesh import make_mesh
    from shardmerge_tpu_torch.parallel.train import make_train_step, tree_flatten

    cfg = ModelConfig(vocab_size=512, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                      num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128)

    def tx():
        return optim.chain(optim.clip_by_global_norm(1.0), optim.adamw(optim.cosine_decay_schedule(3e-3, 200)))

    def recipe(mesh):
        return make_train_step(mesh, cfg, remat=True, zero1=True, master_fp32=True, grad_accum=2, tx=tx())

    mesh = make_mesh(("dp", "tp"), device=args.device)
    first = mesh.rank == 0

    def say(*parts):
        if first:
            print(*parts, flush=True)

    rng = np.random.default_rng(0)  # one batch, repeated: the loss falls
    batches = [torch.from_numpy(rng.integers(0, cfg.vocab_size, (8, 33)))] * args.steps
    out = Path(args.out)
    init_state, train_step = recipe(mesh)
    state = init_state(init_params(cfg, seed=0, dtype=torch.bfloat16))
    losses = []
    for step, batch in enumerate(batches):
        state, loss = train_step(state, batch)
        losses.append(float(loss))
        say(f"step {step}: loss {losses[-1]:.4f} on {mesh}")
        if step == 1:
            save_train_state(out, state, step=2)
            say(f"  checkpointed after 2 steps -> {out}")

    # resume on the transposed mesh from the snapshot, replaying the batches
    shape = tuple(mesh.shape.values())[::-1]
    mesh2 = make_mesh(("dp", "tp"), shape=shape, device=args.device)
    init2, step2 = recipe(mesh2)
    restored, at = restore_train_state(out, init2(init_params(cfg, seed=1, dtype=torch.bfloat16)))
    resumed = []
    for batch in batches[at:]:
        restored, loss = step2(restored, batch)
        resumed.append(float(loss))
        say(f"resumed on {shape}: loss {resumed[-1]:.4f}")

    # QLoRA: the trained params frozen at int8, rank-4 adapters on top
    lay = restored.layout
    whole = [lay.gather("trained", i, v) for i, v in enumerate(tree_flatten(restored["params"])[1])]
    paths = tree_flatten(restored["params"])[0]
    host = {"layers": [{} for _ in range(cfg.num_hidden_layers)]}
    for p, v in zip(paths, whole):
        node = host
        for k in p[:-1]:
            node = node[k]
        node[p[-1]] = quant.quantize(v.float(), 8) if p[-1] in QUANTIZABLE else v.float().cpu()
    lora_init, lora_step = make_lora_train_step(mesh, cfg, rank=4, learning_rate=1e-3, seed=0)
    lstate = lora_init(host)
    lora_losses = []
    for batch in batches[:3]:
        lstate, loss = lora_step(lstate, batch)
        lora_losses.append(float(loss))
        say(f"qlora: loss {lora_losses[-1]:.4f}")
    n_lora = sum(v.numel() for v in tree_flatten(lstate["lora"])[1])
    summary = {"ranks": mesh.size, "mesh": mesh.shape, "losses": losses, "resumed_at": at, "resumed_losses": resumed,
               "qlora_losses": lora_losses, "adapter_params": n_lora}
    if mesh.shape.get("tp", 1) == 1 and first:  # whole adapters on every rank
        summary["adapter"] = lora_to_peft(lstate["lora"], out / "lora", rank=4, alpha=4.0)
    say(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
