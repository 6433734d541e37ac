"""Port vs JAX: training (shardmerge_tpu_torch/models/llama.py
``forward_train``/``block_train``, parallel/{train,optim,mesh,checkpoint}.py,
models/convert.py ``train_state_from_jax`` and quant_kernels.Int4Matmul
against shardmerge_tpu/models/llama.py, parallel/{train,mesh,checkpoint}.py,
optax and the JAX int4 kernel's ``custom_vjp``).

Tiny configs of the existing port tests, one per family the cache-free block
handles; weights from the port's ``init_params`` (f32) with norms, biases and
sinks moved off their init values, carried into JAX as numpy. Gates (f32):
logits relL2 <= 1e-5, loss gradients <= 1e-5 over the tree and <= 1e-4 per
leaf, three train steps' losses within 1e-5 relative and each leaf's update
within relL2 1e-4. The rank tests start gloo processes (tests/torch_ranks.py)
when the module's first test asks for them; they run while the JAX side
computes."""

import json
import pickle
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from shardmerge_tpu_torch.models import llama as tllama
from shardmerge_tpu_torch.models import quant as tquant
from shardmerge_tpu_torch.models import quant_kernels as tqk
from shardmerge_tpu_torch.parallel import checkpoint as tck
from shardmerge_tpu_torch.parallel import mesh as tmesh
from shardmerge_tpu_torch.parallel import optim
from shardmerge_tpu_torch.parallel import train as ttrain

REPO = Path(__file__).resolve().parent.parent

# the dense families' tiny configs (tests/test_torch_families.py), the expert
# and latent ones (tests/test_torch_moe.py), GPT-OSS and Llama-4
_DENSE = {"vocab_size": 128, "hidden_size": 64, "intermediate_size": 128, "num_hidden_layers": 2,
          "num_attention_heads": 4, "num_key_value_heads": 2, "max_position_embeddings": 256, "rms_norm_eps": 1e-5,
          "rope_theta": 10000.0}
_MOE = {**_DENSE, "intermediate_size": 96, "tie_word_embeddings": False}
_MLA = {"num_key_value_heads": 4, "kv_lora_rank": 32, "qk_nope_head_dim": 16, "qk_rope_head_dim": 8,
        "v_head_dim": 16, "moe_intermediate_size": 32, "n_shared_experts": 1, "first_k_dense_replace": 1}
FAMILIES = {
    "llama": {**_DENSE, "model_type": "llama"},
    "qwen3": {**_DENSE, "model_type": "qwen3", "head_dim": 16, "tie_word_embeddings": False},
    "gemma2": {**_DENSE, "model_type": "gemma2", "head_dim": 16, "hidden_activation": "gelu_pytorch_tanh",
               "query_pre_attn_scalar": 24, "attn_logit_softcapping": 5.0, "final_logit_softcapping": 3.0,
               "sliding_window": 4},
    "olmo2": {**_DENSE, "model_type": "olmo2", "tie_word_embeddings": False},
    "gpt_oss": {"model_type": "gpt_oss", "vocab_size": 128, "hidden_size": 64, "intermediate_size": 48,
                "num_hidden_layers": 2, "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 16,
                "num_local_experts": 4, "num_experts_per_tok": 2, "sliding_window": 3,
                "max_position_embeddings": 256, "tie_word_embeddings": False, "attention_bias": True,
                "rms_norm_eps": 1e-5, "rope_theta": 150000.0,
                "rope_scaling": {"rope_type": "yarn", "factor": 32.0, "beta_fast": 32.0, "beta_slow": 1.0,
                                 "truncate": False, "original_max_position_embeddings": 4096},
                "layer_types": ["sliding_attention", "full_attention"], "hidden_act": "silu"},
    "llama4": {"model_type": "llama4_text", "vocab_size": 128, "hidden_size": 64, "intermediate_size": 48,
               "intermediate_size_mlp": 96, "num_hidden_layers": 4, "num_attention_heads": 4,
               "num_key_value_heads": 2, "head_dim": 16, "num_local_experts": 4, "num_experts_per_tok": 2,
               "interleave_moe_layer_step": 2, "no_rope_layers": [1, 1, 1, 0], "attention_chunk_size": 4,
               "attn_temperature_tuning": True, "floor_scale": 2.0, "attn_scale": 0.1, "use_qk_norm": True,
               "max_position_embeddings": 256, "tie_word_embeddings": False, "rms_norm_eps": 1e-5,
               "rope_theta": 10000.0},
    "mixtral": {**_MOE, "model_type": "mixtral", "num_local_experts": 4, "num_experts_per_tok": 2},
    "deepseek_v3": {**_MOE, "model_type": "deepseek_v3", **_MLA, "num_hidden_layers": 3, "q_lora_rank": 24,
                    "n_routed_experts": 8, "num_experts_per_tok": 2, "n_group": 4, "topk_group": 2,
                    "norm_topk_prob": True, "routed_scaling_factor": 2.5,
                    "rope_scaling": {"type": "yarn", "factor": 4.0, "original_max_position_embeddings": 64,
                                     "mscale": 1.0, "mscale_all_dim": 1.0, "beta_fast": 32, "beta_slow": 1}},
}
# JAX's tests/test_train.py _cfg
SMALL = {"vocab_size": 128, "hidden_size": 32, "intermediate_size": 64, "num_hidden_layers": 2,
         "num_attention_heads": 4, "num_key_value_heads": 2, "max_position_embeddings": 64, "model_type": "llama"}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: this host's bf16 matmuls at these sizes take
    ~14 ms on 8 spinning threads and ~0.06 ms on one."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def as_np(t):
    return t.detach().to(torch.float32).numpy()


def family_params(cfg, seed=0):
    """The port's init_params (f32) with norms, biases, sinks and V3's
    selection bias noised, GPT-OSS's gate/up stacks wide enough to reach the
    7.0 clamps."""
    params = tllama.init_params(cfg, seed=seed, dtype=torch.float32)
    gen = torch.Generator().manual_seed(seed + 100)

    def noise(t, s):
        return t + torch.randn(t.shape, generator=gen) * s

    for layer in params["layers"]:
        for key, value in list(layer.items()):
            if key.endswith(("norm", "layernorm")) or key in ("sinks", "moe_gate_bias") or key.endswith("_bias"):
                layer[key] = noise(value, 0.3 if key == "sinks" else 0.2)
            elif key == "gate_bias":
                layer[key] = noise(value, 0.05)
        if "gptoss_experts" in layer:
            e = layer["gptoss_experts"]
            e["gate_up"] = e["gate_up"] * 60.0
            for key in ("gate_up_bias", "down_bias"):
                e[key] = noise(e[key], 0.3)
    params["norm"] = noise(params["norm"], 0.2)
    return params


def to_jax(params):
    import jax
    import jax.numpy as jnp

    return jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), params)


def configs(hf):
    from shardmerge_tpu.models import llama as jllama

    return jllama.ModelConfig.from_hf_config(hf), tllama.ModelConfig.from_hf_config(hf)


def tokens(vocab, shape, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def one_device():
    return tmesh.make_mesh(("dp", "tp"), shape=(1, 1), device="cpu")


def flat_leaves(tree):
    return ttrain.tree_flatten(tree)[1]


# -- the cache-free forward and its gradients ----------------------------------


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_forward_train_and_loss_gradients_match_jax(family):
    """forward_train's f32 logits and _loss_fn's gradients against JAX's
    (jit of forward_train and value_and_grad(_loss_fn)); the logits also
    equal the port's serving prefill on the same ids. GPT-OSS's o_proj bias
    is zero against JAX, whose block_train drops it (the port adds it, as
    serving does: held to the prefill with a noised bias)."""
    import jax

    from shardmerge_tpu.models import llama as jllama
    from shardmerge_tpu.parallel import train as jtrain

    jcfg, tcfg = configs(FAMILIES[family])
    params = family_params(tcfg, seed=3)
    for layer in params["layers"]:
        if "o_bias" in layer:
            layer["o_bias"] = torch.zeros_like(layer["o_bias"])
    batch = tokens(tcfg.vocab_size, (2, 10), seed=4)
    jp = to_jax(params)
    want_logits, (want_loss, want_grads) = jax.jit(
        lambda p, b: (jllama.forward_train(p, jcfg, b[:, :-1]), jax.value_and_grad(jtrain._loss_fn)(p, jcfg, b))
    )(jp, batch)

    leaves = [v.requires_grad_(True) for v in flat_leaves(params)]
    view = ttrain.tree_unflatten(params, leaves)
    logits = tllama.forward_train(view, tcfg, torch.from_numpy(batch[:, :-1]))
    loss = ttrain._loss_fn(view, tcfg, torch.from_numpy(batch))
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)

    rel = rel_l2(as_np(logits), want_logits)
    assert rel <= 1e-5, f"logits relL2 {rel:.2e}"
    assert abs(float(loss.detach()) - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    jleaves = jax.tree_util.tree_leaves(want_grads)
    assert len(jleaves) == len(grads)
    # o_bias: JAX's block_train leaves it out (zero gradient); the port's is real
    paths = ttrain.tree_flatten(params)[0]
    kept = [i for i, p in enumerate(paths) if p[-1] != "o_bias"]
    ours = [np.zeros(jleaves[i].shape) if grads[i] is None else as_np(grads[i]) for i in kept]
    jleaves = [np.asarray(jleaves[i]) for i in kept]
    tree = rel_l2(np.concatenate([o.ravel() for o in ours]), np.concatenate([j.ravel() for j in jleaves]))
    assert tree <= 1e-5, f"gradient tree relL2 {tree:.2e}"
    for path, o, j in zip([paths[i] for i in kept], ours, jleaves):
        if np.linalg.norm(np.asarray(j)) > 0:
            assert rel_l2(o, j) <= 1e-4, (path, rel_l2(o, j))
        else:
            assert not np.any(o), path

    # the serving prefill of the same ids (GPT-OSS with its o_proj bias)
    for layer in params["layers"]:
        if "o_bias" in layer:
            layer["o_bias"] = torch.randn(layer["o_bias"].shape, generator=torch.Generator().manual_seed(5)) * 0.3
    detached = ttrain.tree_unflatten(params, [v.detach() for v in flat_leaves(params)])
    T = batch.shape[1] - 1
    with torch.no_grad():
        train_logits = tllama.forward_train(detached, tcfg, torch.from_numpy(batch[:, :-1]))
        model = tllama.LlamaModel(tcfg, detached)
        pos = torch.arange(T)[None].expand(2, T)
        served, _ = model(torch.from_numpy(batch[:, :-1]).long(), pos, tllama.init_kv_cache(tcfg, 2, T, torch.float32),
                          0, tllama.rope_tables(tcfg, T), T)
    assert rel_l2(as_np(train_logits), as_np(served)) <= 1e-6


def test_remat_is_bit_equal_to_no_remat():
    """remat recomputes each block in the backward with the same ops: two
    steps give the same bits."""
    cfg = tllama.ModelConfig.from_hf_config(SMALL)
    batch = torch.from_numpy(tokens(cfg.vocab_size, (4, 17), seed=1))
    out = []
    for remat in (False, True):
        init, step = ttrain.make_train_step(one_device(), cfg, learning_rate=1e-2, remat=remat)
        state = init(tllama.init_params(cfg, seed=0, dtype=torch.float32))
        losses = []
        for _ in range(2):
            state, loss = step(state, batch)
            losses.append(loss)
        out.append((losses, flat_leaves(state["params"])))
    assert all(torch.equal(a, b) for a, b in zip(out[0][0], out[1][0]))
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))


def test_grad_accum_equals_the_full_batch():
    """grad_accum=2: f32-summed microbatch gradients, one step on their mean:
    the full batch's loss (1e-6 relative) and each leaf's update (relL2
    1e-4, the JAX comparisons' class; measured at most 1.5e-05: Adam's eps
    region turns the microbatches' reduction order into update noise on
    near-zero-variance coordinates, as JAX's own test notes)."""
    cfg = tllama.ModelConfig.from_hf_config(SMALL)
    batch = torch.from_numpy(tokens(cfg.vocab_size, (8, 16), seed=9))
    params = tllama.init_params(cfg, seed=0, dtype=torch.float32)
    runs = {}
    for accum in (1, 2):
        init, step = ttrain.make_train_step(one_device(), cfg, learning_rate=1e-2, grad_accum=accum)
        state, loss = step(init(params), batch)
        runs[accum] = (float(loss), flat_leaves(state["params"]))
    np.testing.assert_allclose(runs[2][0], runs[1][0], rtol=1e-6)
    for path, p0, a, b in zip(ttrain.tree_flatten(params)[0], flat_leaves(params), runs[2][1], runs[1][1]):
        assert rel_l2(a.numpy() - p0.numpy(), b.numpy() - p0.numpy()) <= 1e-4, path
    init, step = ttrain.make_train_step(one_device(), cfg, grad_accum=3)
    with pytest.raises(ValueError, match="not divisible by grad_accum"):
        step(init(params), batch)


@pytest.mark.parametrize("accum", [1, 2])
def test_a_step_leaves_no_tensor_in_a_reference_cycle(accum):
    """With Python's cycle collector off during a step, the collector then
    finds no tensor in unreachable cycles: nothing a step builds
    (tree_unflatten of the leaves, the microbatches' loop) keeps the
    replaced params or the gradients alive past the step. Such a cycle held a
    whole model's copy until the collector next ran (a one-GPU
    Mixtral-width step at grad_accum 2 ran out of the card)."""
    import gc

    cfg = tllama.ModelConfig.from_hf_config(SMALL)
    batch = torch.from_numpy(tokens(cfg.vocab_size, (4, 16), seed=9))
    init, step = ttrain.make_train_step(one_device(), cfg, learning_rate=1e-2, grad_accum=accum)
    state = init(tllama.init_params(cfg, seed=0, dtype=torch.float32))
    gc.collect()
    gc.disable()
    try:
        state, loss = step(state, batch)
        assert torch.isfinite(loss)
        gc.set_debug(gc.DEBUG_SAVEALL)
        gc.collect()
        held = [tuple(o.shape) for o in gc.garbage if isinstance(o, torch.Tensor)]
        assert not held, f"{len(held)} tensors in unreachable cycles: {held[:4]}"
    finally:
        gc.set_debug(0)
        gc.garbage.clear()
        gc.enable()


def test_master_fp32_accumulates_sub_ulp_updates():
    """bf16 params at lr 1e-3: Adam's steps are under half an ulp of the
    norms (1.0), so plain bf16 training leaves them at init while the f32
    master moves them; params stay bf16, the master f32."""
    cfg = tllama.ModelConfig.from_hf_config(SMALL)
    batch = torch.from_numpy(tokens(cfg.vocab_size, (4, 16), seed=5))
    states = {}
    for master in (False, True):
        init, step = ttrain.make_train_step(one_device(), cfg, learning_rate=1e-3, master_fp32=master)
        state = init(tllama.init_params(cfg, seed=0, dtype=torch.bfloat16))
        for _ in range(5):
            state, loss = step(state, batch)
            assert np.isfinite(float(loss))
        states[master] = state
    assert torch.all(states[False]["params"]["layers"][0]["input_layernorm"] == 1.0)
    assert torch.any(states[True]["params"]["layers"][0]["input_layernorm"] != 1.0)
    assert states[True]["params"]["norm"].dtype == torch.bfloat16
    assert all(m.dtype == torch.float32 for m in states[True]["master"])


def test_fsdp_refuses_zero1():
    cfg = tllama.ModelConfig.from_hf_config(SMALL)
    with pytest.raises(ValueError, match="zero1 is subsumed"):
        ttrain.make_train_step(one_device(), cfg, zero1=True, fsdp=True)


# -- train steps against JAX's -------------------------------------------------------


def _jax_steps(hf, params, batch, steps, mesh_shape=(1, 1), chain=False, **opts):
    """JAX's make_train_step on a ``mesh_shape`` mesh: the losses and the
    final params (numpy, flatten order)."""
    import jax
    import jax.numpy as jnp
    import optax

    from shardmerge_tpu.parallel import mesh as jmesh
    from shardmerge_tpu.parallel import train as jtrain

    jcfg, _ = configs(hf)
    n = int(np.prod(mesh_shape))
    mesh = jmesh.make_mesh(("dp", "tp"), devices=jax.devices()[:n], shape=mesh_shape)
    tx = optax.chain(optax.clip_by_global_norm(0.5), optax.adamw(optax.cosine_decay_schedule(1e-2, 4))) if chain \
        else None
    init, step = jtrain.make_train_step(mesh, jcfg, learning_rate=1e-2, tx=tx, **opts)
    state = init(to_jax(params))
    losses = []
    for _ in range(steps):
        state, loss = step(state, jnp.asarray(batch))
        losses.append(float(loss))
    return losses, [np.asarray(v) for v in jax.tree_util.tree_leaves(state["params"])], state, step


def _port_tx(chain):
    return optim.chain(optim.clip_by_global_norm(0.5), optim.adamw(optim.cosine_decay_schedule(1e-2, 4))) \
        if chain else None


@pytest.mark.parametrize("chain", [False, True], ids=["adamw", "clip_cosine"])
def test_three_train_steps_match_jax(chain):
    """Three steps on a one-device mesh, f32: adamw(1e-2), and the
    clip_by_global_norm(0.5) + adamw(cosine_decay_schedule(1e-2, 4)) chain
    (the clip engages): losses within 1e-5 relative, each leaf's update
    within relL2 1e-4 (measured 1.3e-05 / 1.7e-05 at most)."""
    cfg = tllama.ModelConfig.from_hf_config(SMALL)
    params = tllama.init_params(cfg, seed=0, dtype=torch.float32)
    batch = tokens(cfg.vocab_size, (4, 17), seed=0)
    want_losses, want, _, _ = _jax_steps(SMALL, params, batch, 3, chain=chain)
    init, step = ttrain.make_train_step(one_device(), cfg, learning_rate=1e-2, tx=_port_tx(chain))
    state = init(params)
    losses = []
    for _ in range(3):
        state, loss = step(state, torch.from_numpy(batch))
        losses.append(float(loss))
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    for path, p0, got, w in zip(ttrain.tree_flatten(params)[0], flat_leaves(params), flat_leaves(state["params"]),
                                want):
        assert rel_l2(got.numpy() - p0.numpy(), w - p0.numpy()) <= 1e-4, path


def test_optimizer_matches_optax_on_random_leaves():
    """adamw, the clip + cosine chain and apply_updates over random leaves
    against optax, five steps: f32 within 1e-6 relative. bf16: optax rounds
    its Python-float constants (1 - b1, ...) to bf16 before use where the
    port keeps them f32, and both sides then carry their own bf16 moments:
    each step's updates within relL2 2e-2 and the params within 1e-2 of
    optax's (measured 9.3e-03 and 2.3e-03)."""
    import jax
    import jax.numpy as jnp
    import optax

    rng = np.random.default_rng(0)
    shapes = [(8, 4), (16,), (3, 5, 2)]
    for dtype, jdtype in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        params = [torch.from_numpy(rng.normal(0, 1, s).astype(np.float32)).to(dtype) for s in shapes]
        jparams = [jnp.asarray(p.to(torch.float32).numpy(), jdtype) for p in params]
        ours = optim.chain(optim.clip_by_global_norm(2.0), optim.adamw(optim.cosine_decay_schedule(0.1, 7)))
        theirs = optax.chain(optax.clip_by_global_norm(2.0), optax.adamw(optax.cosine_decay_schedule(0.1, 7)))
        s, js = ours.init(params), theirs.init(jparams)
        update = jax.jit(theirs.update)
        for k in range(5):
            grads = [torch.from_numpy(rng.normal(0, 1, p.shape).astype(np.float32)).to(dtype) for p in params]
            jgrads = [jnp.asarray(g.to(torch.float32).numpy(), jdtype) for g in grads]
            u, s = ours.update(grads, s, params)
            ju, js = update(jgrads, js, jparams)
            params, jparams = optim.apply_updates(params, u), optax.apply_updates(jparams, ju)
            flat = [np.concatenate([as_np(t).ravel() for t in ts]) for ts in (u, params)]
            jflat = [np.concatenate([np.asarray(t, np.float32).ravel() for t in ts]) for ts in (ju, jparams)]
            if dtype == torch.float32:
                for a, b in zip(flat, jflat):
                    np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
            else:
                assert rel_l2(flat[0], jflat[0]) <= 2e-2 and rel_l2(flat[1], jflat[1]) <= 1e-2, k
        assert int(s[1][0]["count"]) == int(js[1][0].count) == 5
        assert int(s[1][2]["count"]) == 5


def test_mesh_shape_matches_jax():
    from shardmerge_tpu.parallel import mesh as jmesh

    for n in (1, 2, 4, 6, 8, 12):
        for axes in (1, 2, 3):
            assert tmesh.mesh_shape_for(n, axes) == jmesh.mesh_shape_for(n, axes), (n, axes)


def test_a_jax_train_state_carries_across_and_resumes():
    """train_state_from_jax: JAX's params, optax's Adam count / mu / nu and
    schedule count and the f32 master, after two JAX steps of the clip +
    cosine chain, placed into the port's state; the next step's loss and
    params equal JAX's next step (1e-5)."""
    import jax
    import jax.numpy as jnp

    from shardmerge_tpu_torch.models.convert import train_state_from_jax

    cfg = tllama.ModelConfig.from_hf_config(SMALL)
    params = tllama.init_params(cfg, seed=2, dtype=torch.float32)
    batch = tokens(cfg.vocab_size, (4, 17), seed=3)
    losses, _, jstate, jstep = _jax_steps(SMALL, params, batch, 2, chain=True, master_fp32=True)
    init, step = ttrain.make_train_step(one_device(), cfg, tx=_port_tx(True), master_fp32=True)
    state = train_state_from_jax(jax.tree_util.tree_map(np.asarray, jstate), init(params))
    assert int(state["opt_state"][1][0]["count"]) == 2 and int(state["opt_state"][1][2]["count"]) == 2
    mu = np.asarray(jstate["opt_state"][1][0].mu["layers"][1]["down_proj"])
    where = ttrain.tree_flatten(params)[0].index(("layers", 1, "down_proj"))
    np.testing.assert_array_equal(state["opt_state"][1][0]["mu"][where].numpy(), mu)
    jstate, jloss = jstep(jstate, jnp.asarray(batch))
    state, loss = step(state, torch.from_numpy(batch))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    for got, want in zip(flat_leaves(state["params"]), jax.tree_util.tree_leaves(jstate["params"])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_checkpoint_round_trip_and_refusals(tmp_path):
    """One device: a snapshot at step 2 resumes with the uninterrupted
    trajectory (bit for bit here); the step is in the metadata, the write
    leaves no .tmp; another architecture or precision is refused naming the
    leaf."""
    import dataclasses

    cfg = tllama.ModelConfig.from_hf_config(SMALL)
    batch = torch.from_numpy(tokens(cfg.vocab_size, (4, 16), seed=7))
    init, step = ttrain.make_train_step(one_device(), cfg, learning_rate=1e-2, master_fp32=True,
                                        tx=_port_tx(True))
    state = init(tllama.init_params(cfg, seed=0, dtype=torch.bfloat16))
    for _ in range(2):
        state, _ = step(state, batch)
    file = tck.save_train_state(tmp_path, state, step=2)
    assert file.exists() and not list(tmp_path.glob("*.tmp"))
    ref = []
    for _ in range(2):
        state, loss = step(state, batch)
        ref.append(loss)
    restored, at = tck.restore_train_state(tmp_path, init(tllama.init_params(cfg, seed=9, dtype=torch.bfloat16)))
    assert at == 2
    for want in ref:
        restored, loss = step(restored, batch)
        assert torch.equal(loss, want)
    wrong = dataclasses.replace(cfg, num_hidden_layers=1)
    w_init, _ = ttrain.make_train_step(one_device(), wrong, master_fp32=True, tx=_port_tx(True))
    with pytest.raises(ValueError, match="leaves"):
        tck.restore_train_state(tmp_path, w_init(tllama.init_params(wrong, seed=1, dtype=torch.bfloat16)))
    f_init, _ = ttrain.make_train_step(one_device(), cfg, master_fp32=True, tx=_port_tx(True))
    with pytest.raises(ValueError, match="dtype"):
        tck.restore_train_state(tmp_path, f_init(tllama.init_params(cfg, seed=1, dtype=torch.float32)))


# -- the int4 product's backward -------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int4_matmul_backward_matches_jax_vjp(dtype):
    """Int4Matmul against jax.vjp of JAX's int4_matmul (its Pallas kernel in
    interpret mode, its custom_vjp backward): the forward within relL2 5e-4
    in f32 (the JAX kernel folds the +8 offset out of its product, as
    tests/test_torch_quant.py notes) and 1e-2 in bf16 (it also rounds its
    x_hi / 16 and x_lo - x_hi / 16 operands to bf16: measured 5.2e-03), dx
    within 1e-6 in f32 and 1e-2 in bf16; no gradient for q or scale;
    dequant_matmul routes an x that requires grad through it."""
    import jax
    import jax.numpy as jnp

    from shardmerge_tpu.models import quant_kernels as jqk

    rng = np.random.default_rng(11)
    tdt, jdt = (torch.float32, jnp.float32) if dtype == "float32" else (torch.bfloat16, jnp.bfloat16)
    wq = tquant.quantize(rng.normal(0, 1, (128, 256)).astype(np.float32), bits=4)
    x = torch.from_numpy(rng.normal(0, 1, (3, 5, 256)).astype(np.float32)).to(tdt)
    g = torch.from_numpy(rng.normal(0, 1, (3, 5, 128)).astype(np.float32)).to(tdt)
    jx, jg = jnp.asarray(as_np(x), jdt), jnp.asarray(as_np(g), jdt)
    want, vjp = jax.vjp(lambda a: jqk.int4_matmul(a, jnp.asarray(wq["q"].numpy()), jnp.asarray(wq["scale"].numpy())),
                        jx)
    (want_dx,) = vjp(jg)
    xr = x.clone().requires_grad_(True)
    q, s = wq["q"], wq["scale"].requires_grad_(True)
    y = tqk.Int4Matmul.apply(xr, q, s)
    (dx,) = torch.autograd.grad(y, xr, g)
    assert rel_l2(as_np(y), np.asarray(want, np.float32)) <= (5e-4 if dtype == "float32" else 1e-2)
    assert rel_l2(as_np(dx), np.asarray(want_dx, np.float32)) <= (1e-6 if dtype == "float32" else 1e-2)
    assert dx.dtype == tdt and s.grad is None
    routed = tquant.dequant_matmul(xr, {"q": q, "scale": wq["scale"]})
    assert type(routed.grad_fn).__name__ == "Int4MatmulBackward"
    (dx2,) = torch.autograd.grad(routed, xr, g)
    assert torch.equal(dx2, dx)


# -- ranks ------------------------------------------------------------------------------


def _rank_body(out_dir: Path) -> None:
    """One rank of a launch: ``job`` in out_dir/job.json names what runs."""
    import torch.distributed as dist

    from shardmerge_tpu_torch.parallel import lora as tlora

    job = json.loads((out_dir / "job.json").read_text())
    cfg = tllama.ModelConfig.from_hf_config(job["hf"])
    params = pickle.loads((out_dir / "params.pkl").read_bytes())
    batch = torch.from_numpy(np.asarray(job["batch"], np.int32))
    res = {}

    def run(shape, steps=3, **opts):
        init, step = ttrain.make_train_step(tmesh.make_mesh(("dp", "tp"), shape=shape, device="cpu"), cfg,
                                            learning_rate=1e-2, **opts)
        state = init(params)
        losses = []
        for _ in range(steps):
            state, loss = step(state, batch)
            losses.append(float(loss))
        lay = state.layout
        whole = [as_np(lay.gather("trained", i, v)) for i, v in enumerate(flat_leaves(state["params"]))]
        return losses, whole

    if job["kind"] == "2x2":
        res["dp_tp"] = run((2, 2))
        res["dp_tp_zero1"] = run((2, 2), zero1=True, master_fp32=True)
    else:
        res["replicated"] = run((2, 1))
        res["zero1"] = run((2, 1), zero1=True)
        res["fsdp"] = run((2, 1), fsdp=True, master_fp32=True, remat=True, grad_accum=2)
        res["tp"] = run((1, 2))
        # save on a (2, 1) ZeRO-1 mesh at step 2, restore on (1, 2)
        init, step = ttrain.make_train_step(tmesh.make_mesh(("dp", "tp"), shape=(2, 1), device="cpu"), cfg,
                                            learning_rate=1e-2, zero1=True, master_fp32=True)
        state = init(params)
        for _ in range(2):
            state, _ = step(state, batch)
        tck.save_train_state(out_dir / "ckpt", state, step=2)
        ref = []
        for _ in range(2):
            state, loss = step(state, batch)
            ref.append(float(loss))
        init2, step2 = ttrain.make_train_step(tmesh.make_mesh(("dp", "tp"), shape=(1, 2), device="cpu"), cfg,
                                              learning_rate=1e-2, master_fp32=True)
        restored, at = tck.restore_train_state(out_dir / "ckpt", init2(params))
        resumed = []
        for _ in range(2):
            restored, loss = step2(restored, batch)
            resumed.append(float(loss))
        res["resume"] = (at, ref, resumed)
        # LoRA on an int4 base over dp = 2 and tp = 2
        qparams = pickle.loads((out_dir / "qparams.pkl").read_bytes())
        for shape in ((2, 1), (1, 2)):
            init, step = tlora.make_lora_train_step(tmesh.make_mesh(("dp", "tp"), shape=shape, device="cpu"), cfg,
                                                    rank=4, learning_rate=1e-2, seed=9)
            state = init(qparams)
            losses = []
            for _ in range(3):
                state, loss = step(state, batch)
                losses.append(float(loss))
            res[f"lora{shape}"] = losses
        # LoRA (rank 4 on q/v) over a tp = 2 base, int4 and bf16: saved after one step, the next two
        # steps, and the same two steps from the state restored onto a fresh tp = 2 template
        tp_mesh = tmesh.make_mesh(("dp", "tp"), shape=(1, 2), device="cpu")
        for kind, base in _lora_bases(cfg, qparams).items():
            init, step = tlora.make_lora_train_step(tp_mesh, cfg, rank=4, learning_rate=1e-2, targets=LORA_QV,
                                                    seed=9)
            state, _ = step(init(base), batch)
            tck.save_train_state(out_dir / f"lora_{kind}", state, step=1)
            ref = []
            for _ in range(2):
                state, loss = step(state, batch)
                ref.append(float(loss))
            restored, at = tck.restore_train_state(out_dir / f"lora_{kind}", init(base))
            resumed = []
            for _ in range(2):
                restored, loss = step(restored, batch)
                resumed.append(float(loss))
            res[f"lora_ckpt_{kind}"] = (at, ref, resumed)
    (out_dir / f"rank{dist.get_rank()}.pkl").write_bytes(pickle.dumps(res))


LORA_QV = ("q_proj", "v_proj")


def _lora_bases(cfg, qparams) -> dict:
    """The frozen bases of the tp LoRA checkpoint: the f32 model with its
    projections int4 (``qparams``) or bf16, the activations f32 either way
    (a bf16 model's tp partial sums round apart from one device's: 2.9e-05
    relative in two steps, the layout's gap and not the checkpoint's)."""
    params = tllama.init_params(cfg, seed=0, dtype=torch.float32)
    bf16 = {**params, "layers": [{k: (v.to(torch.bfloat16) if k in tllama.QUANTIZABLE else v) for k, v in layer.items()}
                                 for layer in params["layers"]]}
    return {"int4": qparams, "bf16": bf16}


def _start(tmp_path_factory, name, world, job, params, qparams=None):
    from . import torch_ranks

    d = tmp_path_factory.mktemp(name)
    (d / "job.json").write_text(json.dumps(job))
    (d / "params.pkl").write_bytes(pickle.dumps(params))
    if qparams is not None:
        (d / "qparams.pkl").write_bytes(pickle.dumps(qparams))
    return d, torch_ranks.start([str(Path(__file__).resolve()), str(d)], world, d / "logs")


@pytest.fixture(scope="module")
def launches(tmp_path_factory):
    """Two launches started together: 2 ranks (dp and tp options, the
    checkpoint across layouts, LoRA) and 4 (dp x tp = 2 x 2)."""
    cfg = tllama.ModelConfig.from_hf_config(SMALL)
    params = tllama.init_params(cfg, seed=0, dtype=torch.float32)
    qparams = {**params, "layers": [{k: (tquant.quantize(v, 4) if k in tllama.QUANTIZABLE else v)
                                     for k, v in layer.items()} for layer in params["layers"]]}
    batch = tokens(cfg.vocab_size, (4, 17), seed=0).tolist()
    runs = {
        "two": _start(tmp_path_factory, "two", 2, {"kind": "two", "hf": SMALL, "batch": batch}, params, qparams),
        "2x2": _start(tmp_path_factory, "dp_tp", 4, {"kind": "2x2", "hf": SMALL, "batch": batch}, params),
    }
    state = {"runs": runs, "results": {}, "params": params, "qparams": qparams, "batch": np.asarray(batch, np.int32)}
    yield state
    for _, procs in runs.values():
        for proc in procs:
            if proc.poll() is None:
                proc.kill()


def _results(launches, name, timeout=90):
    from .torch_ranks import wait

    if name not in launches["results"]:
        d, procs = launches["runs"][name]
        for rank, (rc, _, err) in enumerate(wait(procs, d / "logs", timeout)):
            assert rc == 0, f"{name} rank {rank} exited {rc}:\n{err[-3000:]}"
        launches["results"][name] = [pickle.loads((d / f"rank{r}.pkl").read_bytes()) for r in range(len(procs))]
    return launches["results"][name]


def test_dp_by_tp_on_four_ranks_matches_jax_mesh(launches):
    """dp x tp = 2 x 2 on 4 gloo ranks against JAX's (2, 2) mesh, three
    adamw(1e-2) steps, f32: losses within 1e-5 relative, each leaf's update
    within relL2 1e-4; ZeRO-1 with an f32 master on the same mesh gives the
    same trajectory; every rank reports the same."""
    want_losses, want, _, _ = _jax_steps(SMALL, launches["params"], launches["batch"], 3, mesh_shape=(2, 2))
    ranks = _results(launches, "2x2")
    p0 = flat_leaves(launches["params"])
    for res in ranks:
        for key in ("dp_tp", "dp_tp_zero1"):
            losses, whole = res[key]
            np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
            for a, w, b in zip(whole, want, p0):
                assert rel_l2(a - b.numpy(), w - b.numpy()) <= 1e-4, key
    assert ranks[0]["dp_tp"][0] == ranks[3]["dp_tp"][0]


def test_zero1_fsdp_and_tp_on_two_ranks_equal_one_device(launches):
    """Two gloo ranks: dp = 2 replicated, ZeRO-1, fsdp (with master_fp32,
    remat and grad_accum = 2) and tp = 2 each equal the one-device step
    (losses 1e-5 relative, updates relL2 1e-4)."""
    cfg = tllama.ModelConfig.from_hf_config(SMALL)
    params, batch = launches["params"], torch.from_numpy(launches["batch"])
    p0 = flat_leaves(params)
    refs = {}
    for key, opts in (("plain", {}), ("fsdp", dict(master_fp32=True, remat=True, grad_accum=2))):
        init, step = ttrain.make_train_step(one_device(), cfg, learning_rate=1e-2, **opts)
        state = init(params)
        losses = []
        for _ in range(3):
            state, loss = step(state, batch)
            losses.append(float(loss))
        refs[key] = (losses, [as_np(v) for v in flat_leaves(state["params"])])
    for res in _results(launches, "two"):
        for key in ("replicated", "zero1", "fsdp", "tp"):
            want_losses, want = refs["fsdp" if key == "fsdp" else "plain"]
            losses, whole = res[key]
            np.testing.assert_allclose(losses, want_losses, rtol=1e-5, err_msg=key)
            for a, w, b in zip(whole, want, p0):
                assert rel_l2(a - b.numpy(), w - b.numpy()) <= 1e-4, key


def test_checkpoint_from_zero1_layout_resumes_on_tensor_parallel_layout(launches):
    """Saved at step 2 on a (2, 1) ZeRO-1 mesh, restored onto (1, 2): the
    resumed losses equal the uninterrupted run's (1e-5; measured within
    1 f32 ulp)."""
    for res in _results(launches, "two"):
        at, ref, resumed = res["resume"]
        assert at == 2
        np.testing.assert_allclose(resumed, ref, rtol=1e-5)


def test_lora_on_an_int4_base_over_two_ranks_equals_one_device(launches):
    """make_lora_train_step on a packed-int4 base at dp = 2 and at tp = 2
    (the base's row slices re-packed, the replicated factors through f):
    the one-device trajectory (1e-5)."""
    from shardmerge_tpu_torch.parallel import lora as tlora

    cfg = tllama.ModelConfig.from_hf_config(SMALL)
    init, step = tlora.make_lora_train_step(one_device(), cfg, rank=4, learning_rate=1e-2, seed=9)
    state = init(launches["qparams"])
    want = []
    for _ in range(3):
        state, loss = step(state, torch.from_numpy(launches["batch"]))
        want.append(float(loss))
    for res in _results(launches, "two"):
        for shape in ("(2, 1)", "(1, 2)"):
            np.testing.assert_allclose(res[f"lora{shape}"], want, rtol=1e-5, err_msg=shape)


@pytest.mark.parametrize("kind", ["int4", "bf16"])
def test_lora_checkpoint_over_a_tensor_parallel_base_resumes_on_one_device_and_tp(launches, kind):
    """A LoRA state (rank 4 on q/v) trained one step over a tp = 2 base is
    saved whole: the file's base equals the unsliced base bit for bit (the
    int4 row slices' packing over the whole K restored). Restored on tp = 2
    it resumes with the uninterrupted run's losses exactly, on one device
    within 1e-5 relative."""
    from shardmerge_tpu_torch.io.safetensors_io import SafeTensorsReader
    from shardmerge_tpu_torch.parallel import lora as tlora

    cfg = tllama.ModelConfig.from_hf_config(SMALL)
    base = _lora_bases(cfg, launches["qparams"])[kind]
    ranks = _results(launches, "two")
    d = launches["runs"]["two"][0] / f"lora_{kind}"
    with SafeTensorsReader(d / "train_state.safetensors") as r:
        for path, leaf in zip(*ttrain.tree_flatten(base)):
            saved = r.get_tensor("params/" + "/".join(map(str, path)), copy=True)
            assert saved.dtype == leaf.dtype and torch.equal(saved, leaf), path
    at, ref, _ = ranks[0][f"lora_ckpt_{kind}"]
    assert at == 1
    for res in ranks:
        assert res[f"lora_ckpt_{kind}"][2] == ref
    init, step = tlora.make_lora_train_step(one_device(), cfg, rank=4, learning_rate=1e-2, targets=LORA_QV, seed=9)
    other = tllama.init_params(cfg, seed=1, dtype=torch.float32)  # another base: the file's must replace it
    cast = (lambda v: tquant.quantize(v, 4)) if kind == "int4" else (lambda v: v.to(torch.bfloat16))
    other = {**other, "layers": [{k: (cast(v) if k in tllama.QUANTIZABLE else v) for k, v in layer.items()}
                                 for layer in other["layers"]]}
    state, _ = tck.restore_train_state(d, init(other))
    losses = []
    for _ in range(2):
        state, loss = step(state, torch.from_numpy(launches["batch"]))
        losses.append(float(loss))
    np.testing.assert_allclose(losses, ref, rtol=1e-5)


def test_train_recipe_runs_under_torchrun(tmp_path):
    """examples/train_recipe_torch.py on 2 gloo ranks (dp = 2, ZeRO-1, bf16
    with an f32 master): it trains, checkpoints, resumes on the transposed
    (1, 2) mesh within the bf16 class of the uninterrupted losses, trains
    QLoRA adapters and exports them, and prints its JSON summary from rank
    0."""
    from . import torch_ranks

    args = [str(REPO / "examples" / "train_recipe_torch.py"), "--device", "cpu", "--steps", "4",
            "--out", str(tmp_path / "run")]
    results = torch_ranks.launch(args, 2, tmp_path / "logs", timeout=120)
    for rank, (rc, out, err) in enumerate(results):
        assert rc == 0, f"rank {rank} exited {rc}:\n{err[-3000:]}"
    summary = json.loads(results[0][1].strip().splitlines()[-1])
    assert summary["ranks"] == 2 and summary["resumed_at"] == 2
    assert summary["losses"][-1] < summary["losses"][0]
    # bf16 params: on the transposed mesh the tp partial sums round apart
    # (measured 4.8e-05 relative)
    assert summary["resumed_losses"] == pytest.approx(summary["losses"][2:], rel=1e-3)
    assert summary["qlora_losses"][-1] < summary["qlora_losses"][0]
    assert (tmp_path / "run" / "train_state.safetensors").exists()
    assert (tmp_path / "run" / "lora" / "adapter_model.safetensors").exists()


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    _rank_body(Path(sys.argv[1]))
