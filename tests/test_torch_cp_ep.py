"""Port vs JAX: context parallelism (shardmerge_tpu_torch/parallel/ring.py,
parallel/train.py ``make_cp_loss`` / ``make_cp_train_step``), expert
parallelism (parallel/moe.py) and the experts' capacity dispatch
(models/llama.py ``capacity_tables*``, ``_moe_capacity``,
``_moe_deepseek_capacity``, ``stack_expert_weights``, the engine's
``moe_dispatch="capacity"``) against shardmerge_tpu/parallel/ring.py,
parallel/train.py, parallel/moe.py, models/llama.py and inference.py on
JAX's virtual CPU devices.

One launch of 4 gloo ranks (tests/torch_ranks.py) starts with the module's
first test that asks for it and runs every multi-rank case in turn: the ring
and Ulysses on cp = 4, the bounded ring's transfers, the cp loss on (dp, cp)
= (2, 2) and (cp, tp) = (2, 2), three cp train steps, the ep FFN on ep = 2
(a ("rep", "ep") = (2, 2) mesh: two replicas), the ep loss on ep = 2 and
(dp, ep) = (2, 2), two ep train steps. It runs while the parent computes
JAX's references; the ranks import no JAX. Gates (f32), JAX's own: losses
rtol 1e-5, gradients rtol 5e-4 atol 5e-5, attention outputs rtol 1e-5 atol
1e-6 (gradients 1e-4 / 1e-5), the capacity dispatch rtol 2e-5 atol 2e-6;
capacity tables bit for bit; greedy tokens exactly."""

import dataclasses
import json
import pickle
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from shardmerge_tpu_torch.models import llama as tllama
from shardmerge_tpu_torch.models.convert import params_from_jax
from shardmerge_tpu_torch.parallel import mesh as tmesh
from shardmerge_tpu_torch.parallel import moe as tmoe
from shardmerge_tpu_torch.parallel import ring as tring
from shardmerge_tpu_torch.parallel import train as ttrain

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from tests.test_torch_pipeline import jax_mesh, jax_named, named, to_jax, train_tx  # noqa: E402
from tests.test_torch_train import family_params, rel_l2, tokens  # noqa: E402

# JAX's tests/test_parallel.py _pp_cfg, and its cp attention variants (:1971)
PP = dict(vocab_size=64, hidden_size=32, intermediate_size=48, num_hidden_layers=4, num_attention_heads=4,
          num_key_value_heads=2, max_position_embeddings=64)
CP_FAMILIES = {
    "llama": {},
    "gemma2": dict(model_type="gemma2", attn_logit_softcapping=30.0, final_logit_softcapping=30.0, sliding_window=6,
                   query_pre_attn_scalar=16),
    "gpt_oss": dict(model_type="gpt_oss", sliding_window=6,
                    layer_types=("sliding_attention", "full_attention", "sliding_attention", "full_attention"),
                    num_local_experts=4, num_experts_per_tok=2, norm_topk_prob=True),
    "llama4_chunked": dict(attention_chunk_size=8, layer_types=("chunked_attention", "full_attention",
                                                                "chunked_attention", "full_attention")),
}
CP_MESHES = {"dp2_cp2": (("dp", "cp"), (2, 2)), "cp2_tp2": (("cp", "tp"), (2, 2))}
CP_RUNS = [(f, "dp2_cp2") for f in CP_FAMILIES] + [("llama", "cp2_tp2"), ("gpt_oss", "cp2_tp2")]
# (axes, shape, zero1)
CP_TRAIN = {"dp2_cp2": (("dp", "cp"), (2, 2), True), "cp2_tp2": (("cp", "tp"), (2, 2), False)}
# tests/test_moe.py's configs: Mixtral (:219, :392) and DeepSeek-V3 (:271, :472)
MOE = dict(vocab_size=64, hidden_size=32, intermediate_size=48, num_hidden_layers=2, num_attention_heads=4,
           num_key_value_heads=2, num_local_experts=8, num_experts_per_tok=2, norm_topk_prob=True)
DEEPSEEK = dict(MOE, moe_intermediate_size=24, num_key_value_heads=4, model_type="deepseek_v3", kv_lora_rank=16,
                qk_nope_head_dim=8, qk_rope_head_dim=4, v_head_dim=8, n_shared_experts=1, n_group=4, topk_group=2,
                topk_method="noaux_tc", routed_scaling_factor=2.5)
EP_CFGS = {"mixtral": MOE, "deepseek": DEEPSEEK}
# (config, axes, shape, capacity factor)
EP_LOSS = {"mixtral_dp2_ep2": ("mixtral", ("dp", "ep"), (2, 2), None),
           "mixtral_dp2_ep2_cf1": ("mixtral", ("dp", "ep"), (2, 2), 1.0),
           "deepseek_ep2": ("deepseek", ("rep", "ep"), (2, 2), None)}
EP_FFN_CF = (8.0, 1.25)  # n_exp (nothing dropped) and the serving default (drops)
RING = dict(B=2, H=8, KVH=4, T=32, D=8)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jcfg_of(kw):
    from shardmerge_tpu.models import llama as jllama

    return jllama.ModelConfig(**kw)


def cp_kw(family):
    return {**PP, **CP_FAMILIES[family]}


def cp_params(family):
    """The port's init (f32) with norms, biases and GPT-OSS's sinks noised."""
    return family_params(tllama.ModelConfig(**cp_kw(family)), seed=83 + list(CP_FAMILIES).index(family))


def ep_params(name, stacked, seed=10):
    cfg = tllama.ModelConfig(**EP_CFGS[name])
    params = family_params(cfg, seed=seed)
    if stacked:
        assert tllama.stack_expert_weights(params)
    return params


def assert_grads(got: dict, want: dict, rtol=5e-4, atol=5e-5):
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=rtol, atol=atol, err_msg=k)


def unstacked_names(grads: dict) -> dict:
    """Names of a stacked tree's gradients as the expert lists' (layers/i/
    experts/e/w1 ...), for a comparison with a dense one-device step."""
    out = {}
    for k, v in grads.items():
        parts = k.split("/")
        if "experts_stacked" in parts:
            i, w = parts[1], ("w1", "w3", "w2")[int(parts[3])]
            for e in range(v.shape[0]):
                out[f"layers/{i}/experts/{e}/{w}"] = v[e]
        else:
            out[k] = v
    return out


# -- ranks -----------------------------------------------------------------------------------


def _grad_leaves(p):
    leaves = [v.detach().clone().requires_grad_(True) for v in ttrain.tree_flatten(p)[1]]
    return leaves, ttrain.tree_unflatten(p, leaves)


def _whole(lay, mesh, grads) -> dict:
    """Gradients (or leaves) whole: joined over the split axis, summed over
    the data line; on global rank 0, None elsewhere."""
    out = {}
    for i, (p, g) in enumerate(zip(lay.paths, grads)):
        g = torch.zeros(lay.local_shapes[i]) if g is None else g.detach()
        g = lay.gather_tp(i, g)
        if lay.dp > 1:
            g = lay.dp_comm.all_reduce(g)
        out["/".join(map(str, p))] = g.numpy()
    return out if mesh.rank == 0 else None


def _ring_run(job, res):
    mesh = tmesh.make_mesh(("cp",), shape=(4,), device="cpu")
    data = {k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in job["ring"].items()}
    q, k, v, w = (data[n].requires_grad_(n != "w") for n in ("q", "k", "v", "w"))
    scale = 1.0 / np.sqrt(RING["D"])
    c, Tl = mesh.coords["cp"], RING["T"] // 4
    for name, fn in (("ring", tring.ring_attention), ("ulysses", tring.ulysses_attention)):
        out = fn(mesh, q, k, v, scale)
        gq, gk, gv = torch.autograd.grad((out * w[:, :, c * Tl:(c + 1) * Tl]).sum(), (q, k, v))
        whole = [mesh.comm("cp").all_reduce(g) for g in (gq, gk, gv)]
        res[f"{name}/out"] = out.detach().numpy()
        res[f"{name}/grads"] = [g.numpy() for g in whole]
    # the bounded schedule: a window of 6 over Tl = 4 scores 3 blocks and sends 2, forward and back
    comm = mesh.comm("cp")
    qs, ks, vs = (t.detach()[:, :, c * 4:(c + 1) * 4].clone().requires_grad_(True) for t in (q, k, v))
    counts = {}
    for label, window in (("window6", 6), ("full", None)):
        before, hops = comm.stats.get("p2p", [0, 0])[0], tring.stats["hops"]
        out = tring.ring_body(qs, ks, vs, comm, scale, window=window)
        fwd = comm.stats["p2p"][0] - before
        out.sum().backward()
        counts[label] = {"hops": tring.stats["hops"] - hops, "forward": fwd,
                         "backward": comm.stats["p2p"][0] - before - fwd}
    res["schedule"] = counts


def _cp_loss_run(job, family, key, res):
    axes, shape = CP_MESHES[key]
    cfg = tllama.ModelConfig(**job["cp_kw"][family])
    params = pickle.loads((Path(job["dir"]) / f"cp_{family}.pkl").read_bytes())
    batch = torch.from_numpy(np.asarray(job["batch"]["cp"], np.int64))
    mesh = tmesh.make_mesh(axes, shape=shape, device="cpu")
    loss_fn = ttrain.make_cp_loss(mesh, cfg, params)
    leaves, p = _grad_leaves(loss_fn.place(params))
    loss = loss_fn(p, batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    tp = loss_fn.tp
    lay = ttrain._Layout(mesh, params, ttrain.param_cuts(cfg, tp.plan if tp else None, params),
                         data_axes=("dp", "cp"))
    res[f"cp/{family}/{key}"] = {"loss": float(loss), "grads": _whole(lay, mesh, grads)}


def _cp_train_run(job, key, res):
    axes, shape, zero1 = CP_TRAIN[key]
    cfg = tllama.ModelConfig(**job["cp_kw"]["llama"])
    params = pickle.loads((Path(job["dir"]) / "cp_llama.pkl").read_bytes())
    batch = torch.from_numpy(np.asarray(job["batch"]["cp"], np.int64))
    mesh = tmesh.make_mesh(axes, shape=shape, device="cpu")
    init, step = ttrain.make_cp_train_step(mesh, cfg, params, learning_rate=1e-2, remat=True, zero1=zero1,
                                           master_fp32=True, tx=train_tx())
    state = init(params)
    losses = []
    for _ in range(3):
        state, loss = step(state, batch)
        losses.append(float(loss))
    lay = state.layout
    leaves = ttrain.tree_flatten(state["params"])[1]
    whole = {"/".join(map(str, p)): lay.gather("trained", i, v).numpy() for i, (p, v) in enumerate(zip(lay.paths,
                                                                                                      leaves))}
    res[f"cp_train/{key}"] = {"losses": losses, "params": whole if mesh.rank == 0 else None}


def _ep_ffn_run(job, res):
    mesh = tmesh.make_mesh(("rep", "ep"), shape=(2, 2), device="cpu")
    d = Path(job["dir"])
    x = torch.from_numpy(np.asarray(job["ep_x"], np.float32))
    for name in EP_CFGS:
        cfg = tllama.ModelConfig(**EP_CFGS[name])
        layer = pickle.loads((d / f"ep_{name}_stacked.pkl").read_bytes())["layers"][1]
        gate_w, gate_bias, W1, W3, W2 = tmoe.shard_experts(mesh, layer)
        shared = None if "shared_gate_proj" not in layer else tuple(
            layer["shared_" + k] for k in ("gate_proj", "up_proj", "down_proj"))
        for cf in EP_FFN_CF:
            out = tmoe.expert_parallel_ffn(mesh, cfg, gate_w, gate_bias, W1, W3, W2, x, capacity_factor=cf,
                                           shared=shared)
            res[f"ep_ffn/{name}/{cf}"] = out.numpy()


def _ep_loss_run(job, key, res):
    name, axes, shape, cf = EP_LOSS[key]
    cfg = tllama.ModelConfig(**EP_CFGS[name])
    params = pickle.loads((Path(job["dir"]) / f"ep_{name}_stacked.pkl").read_bytes())
    batch = torch.from_numpy(np.asarray(job["batch"]["ep"], np.int64))
    mesh = tmesh.make_mesh(axes, shape=shape, device="cpu")
    loss_fn = tmoe.make_ep_loss(mesh, cfg, params, capacity_factor=cf)
    leaves, p = _grad_leaves(tmoe.ep_params(mesh, params))
    loss = loss_fn(p, batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    lay = ttrain._Layout(mesh, params, tmoe._ep_cuts(mesh, params), split_axis="ep")
    res[f"ep/{key}"] = {"loss": float(loss), "grads": _whole(lay, mesh, grads)}


def _ep_train_run(job, res):
    cfg = tllama.ModelConfig(**MOE)
    params = pickle.loads((Path(job["dir"]) / "ep_mixtral_stacked.pkl").read_bytes())
    batch = torch.from_numpy(np.asarray(job["batch"]["ep"], np.int64))
    mesh = tmesh.make_mesh(("dp", "ep"), shape=(2, 2), device="cpu")
    init, step = tmoe.make_ep_train_step(mesh, cfg, params, learning_rate=1e-2, zero1=True, remat=True)
    state = init(params)
    losses = []
    for _ in range(2):
        state, loss = step(state, batch)
        losses.append(float(loss))
    lay = state.layout
    leaves = ttrain.tree_flatten(state["params"])[1]
    whole = {"/".join(map(str, p)): lay.gather("trained", i, v).numpy() for i, (p, v) in enumerate(zip(lay.paths,
                                                                                                      leaves))}
    local = tuple(state["params"]["layers"][0]["experts_stacked"][0].shape)
    res["ep_train"] = {"losses": losses, "params": whole if mesh.rank == 0 else None, "local_experts": local}


def _rank_body(out_dir: Path) -> None:
    import torch.distributed as dist

    job = json.loads((out_dir / "job.json").read_text())
    res = {}
    _ring_run(job, res)
    for family, key in CP_RUNS:
        _cp_loss_run(job, family, key, res)
    for key in CP_TRAIN:
        _cp_train_run(job, key, res)
    _ep_ffn_run(job, res)
    for key in EP_LOSS:
        _ep_loss_run(job, key, res)
    _ep_train_run(job, res)
    (out_dir / f"rank{dist.get_rank()}.pkl").write_bytes(pickle.dumps(res))


@pytest.fixture(scope="module")
def launch(tmp_path_factory):
    """The 4-rank launch, started at once; its results read on first use."""
    from . import torch_ranks

    d = tmp_path_factory.mktemp("cp_ep_ranks")
    rng = np.random.default_rng(0)
    ring = {n: rng.standard_normal((RING["B"], RING["H"] if n in ("q", "w") else RING["KVH"], RING["T"],
                                    RING["D"])).astype(np.float32).tolist() for n in ("q", "k", "v", "w")}
    for family in CP_FAMILIES:
        (d / f"cp_{family}.pkl").write_bytes(pickle.dumps(cp_params(family)))
    for name in EP_CFGS:
        (d / f"ep_{name}_stacked.pkl").write_bytes(pickle.dumps(ep_params(name, stacked=True)))
    batches = {"cp": tokens(64, (4, 17), seed=84).tolist(), "ep": tokens(64, (4, 13), seed=11).tolist()}
    ep_x = rng.standard_normal((2, 12, 32)).astype(np.float32).tolist()
    (d / "job.json").write_text(json.dumps({"dir": str(d), "ring": ring, "batch": batches, "ep_x": ep_x,
                                            "cp_kw": {f: cp_kw(f) for f in CP_FAMILIES}}))
    env = {"SHARDMERGE_HEARTBEAT_TIMEOUT_S": "120"}
    procs = torch_ranks.start([str(Path(__file__).resolve()), str(d)], 4, d / "logs", env=env)
    state = {"dir": d, "procs": procs, "results": None, "ring": ring, "batch": batches, "ep_x": ep_x}
    yield state
    for p in procs:
        if p.poll() is None:
            p.kill()


def results(launch):
    from .torch_ranks import wait

    if launch["results"] is None:
        d = launch["dir"]
        for rank, (rc, _, err) in enumerate(wait(launch["procs"], d / "logs", 240)):
            assert rc == 0, f"rank {rank} exited {rc}:\n{err[-3000:]}"
        launch["results"] = [pickle.loads((d / f"rank{r}.pkl").read_bytes()) for r in range(4)]
    return launch["results"]


# -- ranks against JAX -------------------------------------------------------------------------


def _full_attention(q, k, v, scale):
    import jax
    import jax.numpy as jnp

    B, H, T, D = q.shape
    KVH = k.shape[1]
    qg = q.reshape(B, KVH, H // KVH, T, D)
    scores = jnp.einsum("bkgtd,bksd->bkgts", qg, k) * scale
    scores = jnp.where(jnp.tril(jnp.ones((T, T), bool))[None, None, None], scores, -1e9)
    return jnp.einsum("bkgts,bksd->bkgtd", jax.nn.softmax(scores, axis=-1), v).reshape(B, H, T, D)


@pytest.mark.parametrize("scheme", ["ring", "ulysses"])
def test_ring_and_ulysses_match_full_attention_and_jax(launch, scheme):
    """ring_attention / ulysses_attention on cp = 4 ranks (H 8, KVH 4, T 32):
    each rank's output block equals full causal attention's and JAX's
    ring_attention / ulysses_attention on a 4-device 'cp' mesh within rtol
    1e-5, atol 1e-6; the gradients of sum(out * w) for q, k and v (each
    rank's part summed over the line) equal full attention's within rtol
    1e-4, atol 1e-5 (JAX's own gates, tests/test_parallel.py:548, :593;
    the ranks are processes, so this also holds JAX's cross-process ring
    test, tests/test_multihost.py:279)."""
    import jax
    import jax.numpy as jnp

    from shardmerge_tpu.parallel.ring import ring_attention, ulysses_attention

    q, k, v, w = (jnp.asarray(np.asarray(launch["ring"][n], np.float32)) for n in ("q", "k", "v", "w"))
    scale = 1.0 / np.sqrt(RING["D"])
    full = np.asarray(_full_attention(q, k, v, scale))
    jfn = ring_attention if scheme == "ring" else ulysses_attention
    jout = np.asarray(jfn(jax_mesh(("cp",), (4,)), q, k, v, scale))
    np.testing.assert_allclose(jout, full, rtol=1e-5, atol=1e-6)
    want = jax.grad(lambda q, k, v: jnp.sum(_full_attention(q, k, v, scale) * w), argnums=(0, 1, 2))(q, k, v)
    Tl = RING["T"] // 4
    for c, res in enumerate(results(launch)):
        np.testing.assert_allclose(res[f"{scheme}/out"], full[:, :, c * Tl:(c + 1) * Tl], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(res[f"{scheme}/out"], jout[:, :, c * Tl:(c + 1) * Tl], rtol=1e-5, atol=1e-6)
        for got, g in zip(res[f"{scheme}/grads"], want):
            np.testing.assert_allclose(got, np.asarray(g), rtol=1e-4, atol=1e-5)


def test_windowed_ring_sends_only_the_blocks_inside_the_window(launch):
    """A window of 6 over Tl = 4 on cp = 4: the ring scores ceil(6/4) + 1 =
    3 blocks, not 4, and sends 2 (forward and, reversed, backward; Comm's
    p2p counter), full attention 4 and 3 (JAX counts its scan length,
    tests/test_parallel.py:2014)."""
    for res in results(launch):
        assert res["schedule"] == {"window6": {"hops": 3, "forward": 2, "backward": 2},
                                   "full": {"hops": 4, "forward": 3, "backward": 3}}
    assert tring.ring_hops(4, 4, window=6) == 3 and tring.ring_hops(8, 4, window=6) == 3
    assert tring.ring_hops(4, 4, chunk=8) == 3 and tring.ring_hops(4, 4) == 4


@pytest.mark.parametrize("family,key", CP_RUNS, ids=[f"{f}-{k}" for f, k in CP_RUNS])
def test_cp_loss_and_gradients_match_jax(launch, family, key):
    """make_cp_loss on (dp, cp) = (2, 2) and (cp, tp) = (2, 2) against JAX's
    make_cp_loss on the same mesh shape and against the one-device
    _loss_fn (JAX's and the port's), B 4, T 16: plain Llama, Gemma-2's
    softcaps and alternating windows, GPT-OSS's sinks (nonzero) and
    windows, Llama-4's chunks; GPT-OSS's expert stacks split over tp.
    Loss rtol 1e-5, every gradient (summed over the data ranks, joined
    over tp) rtol 5e-4, atol 5e-5 (JAX's tests/test_parallel.py:1971,
    :2549)."""
    import jax
    import jax.numpy as jnp

    from shardmerge_tpu.parallel.train import _loss_fn, make_cp_loss

    jcfg = jcfg_of(cp_kw(family))
    params = pickle.loads((launch["dir"] / f"cp_{family}.pkl").read_bytes())
    jparams = to_jax(params)
    batch = jnp.asarray(np.asarray(launch["batch"]["cp"], np.int32))
    jloss, jgrads = jax.jit(jax.value_and_grad(make_cp_loss(jax_mesh(*CP_MESHES[key]), jcfg, jparams)))(jparams,
                                                                                                           batch)
    ref_loss, ref_grads = jax.jit(jax.value_and_grad(lambda p, b: _loss_fn(p, jcfg, b)))(jparams, batch)
    want = jax_named(jgrads)
    tcfg = tllama.ModelConfig(**cp_kw(family))
    leaves, p = _grad_leaves(params)
    one = ttrain._loss_fn(p, tcfg, torch.from_numpy(np.asarray(launch["batch"]["cp"], np.int64)))
    one_grads = dict(zip(named(params), (g.numpy() for g in torch.autograd.grad(one, leaves))))
    ranks = results(launch)
    for res in ranks:
        got = res[f"cp/{family}/{key}"]["loss"]
        assert got == pytest.approx(float(jloss), rel=1e-5)
        assert got == pytest.approx(float(ref_loss), rel=1e-5) and got == pytest.approx(float(one.detach()), rel=1e-5)
    got = ranks[0][f"cp/{family}/{key}"]["grads"]
    assert_grads(got, want)
    assert_grads(got, jax_named(ref_grads))
    assert_grads(got, one_grads)


@pytest.mark.parametrize("key", list(CP_TRAIN))
def test_three_cp_train_steps_match_jax(launch, key):
    """Three make_cp_train_step steps of the plain config with remat,
    master_fp32, the clip_by_global_norm(0.5) + adamw(cosine) chain and, on
    (dp, cp), ZeRO-1 over both data axes, against JAX's make_cp_train_step
    on the same mesh shape: losses within 1e-5 relative, each leaf's update
    within relL2 1e-4 of JAX's, or within twice JAX's own distance between
    that step and its one-device make_train_step where that is larger (one
    element of layers/3/input_layernorm, whose Adam moments sit in the eps
    region: JAX's two layouts put it 5.4e-4 / 4.0e-4 apart, ROADMAP.md)."""
    import jax.numpy as jnp
    import optax

    from shardmerge_tpu.parallel.train import make_cp_train_step, make_train_step

    axes, shape, zero1 = CP_TRAIN[key]
    jcfg = jcfg_of(cp_kw("llama"))
    params = pickle.loads((launch["dir"] / "cp_llama.pkl").read_bytes())
    batch = jnp.asarray(np.asarray(launch["batch"]["cp"], np.int32))

    def jax_run(init, step):
        state = init(to_jax(params))
        losses = []
        for _ in range(3):
            state, loss = step(state, batch)
            losses.append(float(loss))
        return losses, jax_named(state["params"])

    def tx():
        return optax.chain(optax.clip_by_global_norm(0.5), optax.adamw(optax.cosine_decay_schedule(1e-2, 4)))

    want_losses, want = jax_run(*make_cp_train_step(jax_mesh(axes, shape), jcfg, to_jax(params), remat=True,
                                                    zero1=zero1, master_fp32=True, tx=tx()))
    _, one = jax_run(*make_train_step(jax_mesh(("dp", "tp"), (1, 1)), jcfg, remat=True, master_fp32=True, tx=tx()))
    start = named(params)
    ranks = results(launch)
    for res in ranks:
        np.testing.assert_allclose(res[f"cp_train/{key}"]["losses"], want_losses, rtol=1e-5)
    got = ranks[0][f"cp_train/{key}"]["params"]
    assert set(got) == set(want)
    for k, w in want.items():
        bound = max(1e-4, 2 * rel_l2(one[k] - start[k], w - start[k]))
        assert rel_l2(got[k] - start[k], w - start[k]) <= bound, k


@pytest.mark.parametrize("name", list(EP_CFGS))
def test_expert_parallel_ffn_matches_jax_and_dense(launch, name):
    """expert_parallel_ffn on ep = 2 (Mixtral, 8 experts; DeepSeek-V3's
    grouped router with its selection bias and shared experts), x (2, 12,
    32): at capacity factor n_exp nothing is dropped and it equals the
    one-device dense-and-mask FFN; at 1.25 tokens are dropped (checked on
    the tables) and it equals the port's one-device _moe_capacity /
    _moe_deepseek_capacity; at both it equals JAX's expert_parallel_ffn on
    a 2-device 'ep' mesh. rtol 2e-5, atol 2e-6 (tests/test_moe.py:219,
    :271)."""
    from shardmerge_tpu.parallel.moe import expert_parallel_ffn, shard_experts

    cfg = tllama.ModelConfig(**EP_CFGS[name])
    jcfg = jcfg_of(EP_CFGS[name])
    layer = pickle.loads((launch["dir"] / f"ep_{name}_stacked.pkl").read_bytes())["layers"][1]
    dense_layer = {k: v for k, v in layer.items() if k != "experts_stacked"}
    dense_layer["experts"] = [{w: s[e] for w, s in zip(("w1", "w3", "w2"), layer["experts_stacked"])}
                              for e in range(cfg.num_local_experts)]
    x = torch.from_numpy(np.asarray(launch["ep_x"], np.float32))
    dense = tllama._experts_train(cfg, dense_layer, x, None).numpy()
    jlayer = to_jax(dense_layer)
    mesh = jax_mesh(("ep",), (2,))
    gate_w, gate_bias, W1, W3, W2 = shard_experts(mesh, jlayer)
    shared = None if "shared_gate_proj" not in jlayer else tuple(
        jlayer["shared_" + k] for k in ("gate_proj", "up_proj", "down_proj"))
    xf = x.reshape(-1, 32)
    idx, w = tllama.route_experts(cfg, layer["moe_gate"], layer.get("gate_bias"), xf)
    for cf in EP_FFN_CF:
        want = np.asarray(expert_parallel_ffn(mesh, jcfg, gate_w, gate_bias, W1, W3, W2, x.numpy(),
                                              capacity_factor=cf, shared=shared))
        C = tllama.capacity_of(cfg, xf.shape[0], cf)
        _, w_slot = tllama.capacity_tables_from_topk(idx, w, cfg.num_local_experts, C)
        kept = int((w_slot != 0).sum())
        if cf == 8.0:
            assert kept == xf.shape[0] * 2
            single = dense
        else:
            assert kept < xf.shape[0] * 2  # tokens dropped
            capfn = tllama._moe_deepseek_capacity if name == "deepseek" else tllama._moe_capacity
            single = capfn(cfg, layer, x, cf).numpy()
        for res in results(launch):
            got = res[f"ep_ffn/{name}/{cf}"]
            np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-6)
            np.testing.assert_allclose(got, single, rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("key", list(EP_LOSS))
def test_ep_loss_and_gradients_match_jax_and_dense(launch, key):
    """make_ep_loss on (dp, ep) = (2, 2) (Mixtral) and ep = 2 (DeepSeek-V3:
    MLA attention, a dense first layer, shared experts) against JAX's
    make_ep_loss on the same mesh shape: loss rtol 1e-5, every gradient
    (experts joined over ep, summed over dp) rtol 5e-4, atol 5e-5. With no
    capacity factor (nothing dropped) also against the one-device
    dense-and-mask _loss_fn on the expert lists; with factor 1.0 (tokens
    dropped) against JAX only (tests/test_moe.py:392, :472)."""
    import jax
    import jax.numpy as jnp

    from shardmerge_tpu.parallel.moe import make_ep_loss

    name, axes, shape, cf = EP_LOSS[key]
    cfg, jcfg = tllama.ModelConfig(**EP_CFGS[name]), jcfg_of(EP_CFGS[name])
    sparams = pickle.loads((launch["dir"] / f"ep_{name}_stacked.pkl").read_bytes())
    jparams = to_jax(sparams)
    jaxes = tuple(a for a in axes if a != "rep")
    jshape = tuple(s for a, s in zip(axes, shape) if a != "rep")
    batch = np.asarray(launch["batch"]["ep"], np.int32)
    jloss, jgrads = jax.jit(jax.value_and_grad(make_ep_loss(jax_mesh(jaxes, jshape), jcfg, jparams,
                                                            capacity_factor=cf)))(jparams, jnp.asarray(batch))
    ranks = results(launch)
    for res in ranks:
        assert res[f"ep/{key}"]["loss"] == pytest.approx(float(jloss), rel=1e-5)
    got = ranks[0][f"ep/{key}"]["grads"]
    assert_grads(got, jax_named(jgrads))
    if cf is None:
        dense = ep_params(name, stacked=False)
        leaves, p = _grad_leaves(dense)
        one = ttrain._loss_fn(p, cfg, torch.from_numpy(batch.astype(np.int64)))
        assert float(one.detach()) == pytest.approx(ranks[0][f"ep/{key}"]["loss"], rel=1e-5)
        grads = torch.autograd.grad(one, leaves, allow_unused=True)  # V3's selection bias takes none
        assert_grads(unstacked_names(got), {k: np.zeros_like(v) if g is None else g.numpy()
                                            for (k, v), g in zip(named(dense).items(), grads)})


def test_two_ep_train_steps_match_jax_and_one_device(launch):
    """Two make_ep_train_step steps (Mixtral, (dp, ep) = (2, 2), adamw(1e-2),
    remat, ZeRO-1 over dp): each rank holds 4 of the 8 experts; losses
    within 1e-5 relative and each leaf's update within relL2 1e-4 of JAX's
    make_ep_train_step on the same mesh and of two one-device
    make_train_step steps on the expert lists (the dense-and-mask loss)."""
    import jax.numpy as jnp

    from shardmerge_tpu.parallel.moe import make_ep_train_step

    sparams = pickle.loads((launch["dir"] / "ep_mixtral_stacked.pkl").read_bytes())
    batch = np.asarray(launch["batch"]["ep"], np.int32)
    init, step = make_ep_train_step(jax_mesh(("dp", "ep"), (2, 2)), jcfg_of(MOE), to_jax(sparams),
                                    learning_rate=1e-2, zero1=True, remat=True)
    state = init(to_jax(sparams))
    want_losses = []
    for _ in range(2):
        state, loss = step(state, jnp.asarray(batch))
        want_losses.append(float(loss))
    want = jax_named(state["params"])
    dense = ep_params("mixtral", stacked=False)
    init1, step1 = ttrain.make_train_step(tmesh.make_mesh(("dp", "tp"), shape=(1, 1), device="cpu"),
                                          tllama.ModelConfig(**MOE), learning_rate=1e-2)
    one = init1(dense)
    one_losses = []
    for _ in range(2):
        one, loss = step1(one, torch.from_numpy(batch.astype(np.int64)))
        one_losses.append(float(loss))
    one_named = named(one["params"])
    start, start_dense = named(sparams), named(dense)
    ranks = results(launch)
    for res in ranks:
        r = res["ep_train"]
        assert r["local_experts"] == (4, 48, 32)
        np.testing.assert_allclose(r["losses"], want_losses, rtol=1e-5)
        np.testing.assert_allclose(r["losses"], one_losses, rtol=1e-5)
    got = ranks[0]["ep_train"]["params"]
    assert set(got) == set(want)
    for k, w in want.items():
        assert rel_l2(got[k] - start[k], w - start[k]) <= 1e-4, k
    got_dense = unstacked_names({k: v - start[k] for k, v in got.items()})
    for k, v in got_dense.items():
        assert rel_l2(v, one_named[k] - start_dense[k]) <= 1e-4, k


# -- one process -------------------------------------------------------------------------------


CAP_CASES = {"ties": (12, 4, 2, 3), "no_drop": (9, 8, 2, 9), "overflow": (30, 6, 3, 4), "one_slot": (16, 8, 2, 1)}


@pytest.mark.parametrize("case", list(CAP_CASES))
def test_capacity_tables_are_jax_bits(case):
    """capacity_tables and capacity_tables_from_topk on random routers
    (seeded), with exact ties planted in the probabilities and experts over
    capacity: gather_idx and w_slot bit-equal to JAX's (the cumsum over the
    token-major (S, k) table decides which assignment overflows)."""
    import jax.numpy as jnp

    from shardmerge_tpu.models import llama as jllama

    S, n, k, C = CAP_CASES[case]
    rng = np.random.default_rng(list(CAP_CASES).index(case))
    probs = rng.random((S, n)).astype(np.float32)
    probs[::3, 1] = probs[::3, 0]  # exact ties: the lower index wins
    probs = probs / probs.sum(-1, keepdims=True)
    for norm in (True, False):
        want = jllama.capacity_tables(jnp.asarray(probs), k, C, norm)
        got = tllama.capacity_tables(torch.from_numpy(probs), k, C, norm)
        for g, w in zip(got, want):
            assert np.array_equal(g.numpy(), np.asarray(w))
    idx = rng.integers(0, n, (S, k))
    w = rng.random((S, k)).astype(np.float32)
    want = jllama.capacity_tables_from_topk(jnp.asarray(idx), jnp.asarray(w), n, C)
    got = tllama.capacity_tables_from_topk(torch.from_numpy(idx), torch.from_numpy(w), n, C)
    for g, ww in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(ww))


MOE_FFN = dict(vocab_size=64, hidden_size=32, intermediate_size=48, num_hidden_layers=1, num_attention_heads=4,
               num_key_value_heads=2, num_local_experts=4, num_experts_per_tok=2)


@pytest.mark.parametrize("cf", [4.0, 1.0, 0.5])
def test_moe_capacity_matches_jax(cf):
    """_moe_capacity against JAX's on the same stacked experts (x (2, 9,
    32), seeded), through _ffn's dispatch on both sides: at factor 4 (=
    n_exp: nothing dropped) both equal the dense-and-mask FFN; at 1.0 and
    0.5 (tokens dropped) the port equals JAX's. rtol 2e-5, atol 2e-6
    (tests/test_moe.py:177)."""
    import jax.numpy as jnp

    from shardmerge_tpu.models import llama as jllama

    cfg = tllama.ModelConfig(**MOE_FFN, moe_dispatch="capacity", moe_capacity_factor=cf)
    jcfg = jcfg_of({**MOE_FFN, "moe_dispatch": "capacity", "moe_capacity_factor": cf})
    layer = tllama.init_params(cfg, seed=0, dtype=torch.float32)["layers"][0]
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 9, 32)).astype(np.float32))
    dense = tllama._experts_train(dataclasses.replace(cfg, moe_dispatch="dense"), layer, x, None).numpy()
    want = np.asarray(jllama._ffn(jcfg, to_jax(layer), jnp.asarray(x.numpy())))
    stacked = {k: v for k, v in layer.items() if k != "experts"}
    stacked["experts_stacked"] = tllama.expert_stacks(layer)
    for got in (tllama._moe_capacity(cfg, layer, x, cf), tllama._experts_train(cfg, stacked, x, None)):
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-6)
    idx, w = tllama.route_experts(cfg, layer["moe_gate"], None, x.reshape(18, 32))
    kept = int((tllama.capacity_tables_from_topk(idx, w, 4, tllama.capacity_of(cfg, 18, cf))[1] != 0).sum())
    if cf == 4.0:
        assert kept == 36
        np.testing.assert_allclose(want, dense, rtol=2e-5, atol=2e-6)
    else:
        assert kept < 36  # tokens dropped


@pytest.mark.parametrize("cf", [8.0, 1.0])
def test_moe_deepseek_capacity_matches_jax(cf):
    """_moe_deepseek_capacity against JAX's (DeepSeek-V3's router with a
    nonzero selection bias, shared experts), at factor 8 (nothing dropped:
    also the dense-and-mask FFN) and 1.0 (tokens dropped). rtol 2e-5, atol
    2e-6 (tests/test_moe.py:340)."""
    import jax.numpy as jnp

    from shardmerge_tpu.models import llama as jllama

    kw = {**DEEPSEEK, "num_hidden_layers": 1}
    cfg = tllama.ModelConfig(**kw)
    jcfg = jcfg_of(kw)
    layer = family_params(cfg, seed=3)["layers"][0]
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((2, 12, 32)).astype(np.float32))
    want = np.asarray(jllama._moe_deepseek_capacity(jcfg, to_jax(layer), jnp.asarray(x.numpy()), cf))
    np.testing.assert_allclose(tllama._moe_deepseek_capacity(cfg, layer, x, cf).numpy(), want, rtol=2e-5,
                               atol=2e-6)
    if cf == 8.0:
        np.testing.assert_allclose(tllama._experts_train(cfg, layer, x, None).numpy(), want, rtol=2e-5, atol=2e-6)


def test_stack_expert_weights_and_the_serving_module_match_jax():
    """stack_expert_weights replaces each expert list by (W1, W3, W2)
    stacks bit-equal to JAX's and refuses quantized experts (False,
    nothing changed) as JAX does; JAX's stacked tree converts to the same
    tuple (models/convert.py). The serving MoE module: stacked under the
    capacity dispatch equals JAX's _ffn; under the dense one, the same bits
    as its expert list; LlamaModel.stack_experts refuses a quantized
    model."""
    import jax
    import jax.numpy as jnp

    from shardmerge_tpu.models import llama as jllama
    from shardmerge_tpu_torch.models import quant as tquant

    cfg = tllama.ModelConfig(**MOE_FFN, moe_dispatch="capacity", moe_capacity_factor=1.25)
    jcfg = jcfg_of({**MOE_FFN, "moe_dispatch": "capacity", "moe_capacity_factor": 1.25})
    params = tllama.init_params(cfg, seed=2, dtype=torch.float32)
    jparams = to_jax(params)
    assert tllama.stack_expert_weights(params) and jllama.stack_expert_weights(jparams)
    assert "experts" not in params["layers"][0]
    for g, w in zip(params["layers"][0]["experts_stacked"], jparams["layers"][0]["experts_stacked"]):
        assert np.array_equal(g.numpy(), np.asarray(w))
    conv = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    assert isinstance(conv["layers"][0]["experts_stacked"], tuple)
    x = np.random.default_rng(4).standard_normal((2, 9, 32)).astype(np.float32)
    want = np.asarray(jllama._ffn(jcfg, jparams["layers"][0], jnp.asarray(x)))
    module = tllama.MoE(cfg, params["layers"][0])
    np.testing.assert_allclose(module(torch.from_numpy(x)).numpy(), want, rtol=2e-5, atol=2e-6)
    dense_cfg = dataclasses.replace(cfg, moe_dispatch="dense")
    listed = tllama.MoE(dense_cfg, tllama.init_params(cfg, seed=2, dtype=torch.float32)["layers"][0])
    stacked = tllama.MoE(dense_cfg, params["layers"][0])
    assert torch.equal(listed(torch.from_numpy(x)), stacked(torch.from_numpy(x)))
    qparams = tllama.init_params(cfg, seed=2, dtype=torch.float32)
    for e in qparams["layers"][0]["experts"]:
        for k in ("w1", "w3", "w2"):
            e[k] = tquant.quantize(e[k], 8)
    assert not tllama.stack_expert_weights(qparams) and "experts" in qparams["layers"][0]
    assert not tllama.LlamaModel(cfg, qparams).stack_experts()


def _engines(family, cf):
    """(port engine, JAX engine) on the same weights under the capacity
    dispatch at factor ``cf``."""
    from shardmerge_tpu.inference import InferenceEngine as JaxEngine
    from shardmerge_tpu_torch.inference import InferenceEngine

    from tests.test_torch_moe import StubTokenizer, models

    jcfg, jparams, tcfg, model = models(family, seed=1, moe_dispatch="capacity", moe_capacity_factor=cf)
    return InferenceEngine(tcfg, model, StubTokenizer()), JaxEngine(jcfg, jparams, StubTokenizer())


@pytest.mark.parametrize("family", ["mixtral", "deepseek_v3"])
def test_engine_capacity_route_greedy_tokens_equal_jax(family):
    """The engine under moe_dispatch="capacity" stacks the experts once and
    decodes through the capacity dispatch: at factor 1.25 (below n_exp / k,
    so the prompt's tokens compete for slots) a single unpadded prompt's
    greedy stream equals the JAX engine's; at factor n_exp / k (every
    token fits) a ragged left-padded batch's tokens equal JAX's too."""
    kw = dict(max_new_tokens=6, greedy=True, use_template=False)
    teng, jeng = _engines(family, 1.25)
    assert all(layer.mlp.stacks is not None for layer in teng.model.layers if isinstance(layer.mlp, tllama.MoE))
    prompt = "experts route tokens to their slots"
    assert "".join(teng.stream_generation(prompt, **kw)) == "".join(jeng.stream_generation(prompt, **kw))
    n_exp = 4 if family == "mixtral" else 8
    teng, jeng = _engines(family, n_exp / 2)
    prompts = ["hello there", "a", "the quick brown fox"]
    assert teng.generate_batch(prompts, **kw) == jeng.generate_batch(prompts, **kw)


def test_engine_refuses_the_capacity_route_for_quantized_experts(caplog):
    """Quantized experts keep the dense-and-mask route under
    moe_dispatch="capacity", with JAX's warning (shardmerge_tpu/
    inference.py:283-291)."""
    from shardmerge_tpu_torch.inference import InferenceEngine

    from tests.test_torch_moe import StubTokenizer, models

    _, _, tcfg, model = models("mixtral", seed=1, bits=8, moe_dispatch="capacity")
    with caplog.at_level("WARNING"):
        InferenceEngine(tcfg, model, StubTokenizer())
    assert "quantized experts serve via the dense-and-mask path" in caplog.text
    assert all(layer.mlp.stacks is None for layer in model.layers)


def test_refusals_are_jax_messages():
    """Every refusal with JAX's message, JAX raising the same: ring_attention
    (T indivisible by cp, heads that do not group), ulysses_attention (cp
    not dividing T, H and KVH), make_cp_loss (MLA; GPT-OSS experts
    indivisible by tp; tp not dividing heads / KV heads / ffn; quantized
    GPT-OSS stacks under tp), make_ep_loss (no 'ep' axis; experts
    indivisible by ep; fused stacks; expert lists; quantized stacks),
    make_ep_train_step's zero1 without dp, expert_parallel_ffn's experts
    indivisible by the devices (tests/test_parallel.py:2063,
    tests/test_moe.py:539)."""
    import jax.numpy as jnp

    from shardmerge_tpu.models import llama as jllama
    from shardmerge_tpu.parallel import moe as jmoe
    from shardmerge_tpu.parallel import ring as jring
    from shardmerge_tpu.parallel import train as jtrain

    def both(err, match, port, jax_fn):
        with pytest.raises(err, match=match):
            port()
        with pytest.raises(err, match=match):
            jax_fn()

    def tm(axes, shape):
        return tmesh.Mesh(axes, shape, 0, "cpu")

    q = np.zeros((2, 4, 30, 8), np.float32)
    both(ValueError, "^sequence 30 does not divide cp=4$",
         lambda: tring.ring_attention(tm(("cp",), (4,)), *(torch.from_numpy(q),) * 3, 0.5),
         lambda: jring.ring_attention(jax_mesh(("cp",), (4,)), *(jnp.asarray(q),) * 3, 0.5))
    k3 = np.zeros((2, 3, 32, 8), np.float32)
    q32 = np.zeros((2, 4, 32, 8), np.float32)
    both(ValueError, "^4 heads do not group over 3 kv heads$",
         lambda: tring.ring_attention(tm(("cp",), (4,)), torch.from_numpy(q32), *(torch.from_numpy(k3),) * 2, 0.5),
         lambda: jring.ring_attention(jax_mesh(("cp",), (4,)), jnp.asarray(q32), *(jnp.asarray(k3),) * 2, 0.5))
    both(ValueError, "^cp=4 must evenly divide T=32, H=4, KVH=3$",
         lambda: tring.ulysses_attention(tm(("cp",), (4,)), torch.from_numpy(q32), *(torch.from_numpy(k3),) * 2,
                                         0.5),
         lambda: jring.ulysses_attention(jax_mesh(("cp",), (4,)), jnp.asarray(q32), *(jnp.asarray(k3),) * 2, 0.5))

    def cp_case(kw, axes, shape, err, match, edit=None):
        params = tllama.init_params(tllama.ModelConfig(**kw), seed=0, dtype=torch.float32)
        jparams = to_jax(params)
        if edit is not None:
            params, jparams = edit(params), edit(jparams)
        both(err, match, lambda: ttrain.make_cp_loss(tm(axes, shape), tllama.ModelConfig(**kw), params),
             lambda: jtrain.make_cp_loss(jax_mesh(axes, shape), jcfg_of(kw), jparams))

    mla = dict(PP, num_hidden_layers=2, model_type="deepseek_v2", q_lora_rank=16, kv_lora_rank=16,
               qk_nope_head_dim=8, qk_rope_head_dim=4, v_head_dim=8)
    cp_case(mla, ("dp", "cp"), (2, 2), NotImplementedError, "^MLA attention does not ring-decompose$")
    oss = dict(PP, num_hidden_layers=2, **{k: v for k, v in CP_FAMILIES["gpt_oss"].items() if k != "layer_types"},
               layer_types=("sliding_attention", "full_attention"))
    cp_case(dict(oss, num_local_experts=3), ("dp", "cp", "tp"), (1, 2, 2), ValueError,
            "^gpt-oss under cp x tp shards the expert dim: 3 experts must divide tp=2$")
    cp_case(dict(PP, num_hidden_layers=2, num_key_value_heads=1), ("cp", "tp"), (2, 2), ValueError,
            "^tp=2 must evenly divide heads/kv-heads/ffn$")

    def quantize_stacks(params):  # a {"q3", "scale"} stack: the refusal reads only its kind
        for layer in params["layers"]:
            e = layer["gptoss_experts"]
            e["gate_up"] = {"q3": e["gate_up"], "scale": e["gate_up"]}
        return params

    cp_case(oss, ("cp", "tp"), (2, 2), NotImplementedError,
            r"^quantized gpt-oss expert stacks do not train under cp x tp \(dequantize first\)$", quantize_stacks)

    def ep_case(kw, axes, shape, err, match, stacked=True, edit=None, fn="loss"):
        params = tllama.init_params(tllama.ModelConfig(**kw), seed=0, dtype=torch.float32)
        jparams = to_jax(params)
        if stacked:
            assert tllama.stack_expert_weights(params) and jllama.stack_expert_weights(jparams)
        if edit is not None:
            params, jparams = edit(params), edit(jparams)
        if fn == "loss":
            both(err, match, lambda: tmoe.make_ep_loss(tm(axes, shape), tllama.ModelConfig(**kw), params),
                 lambda: jmoe.make_ep_loss(jax_mesh(axes, shape), jcfg_of(kw), jparams))
        else:
            both(err, match, lambda: tmoe.make_ep_train_step(tm(axes, shape), tllama.ModelConfig(**kw), params,
                                                             zero1=True),
                 lambda: jmoe.make_ep_train_step(jax_mesh(axes, shape), jcfg_of(kw), jparams, zero1=True))

    moe1 = dict(MOE, num_hidden_layers=1)
    ep_case(moe1, ("dp",), (2,), ValueError, "^make_ep_loss needs an 'ep' axis in the mesh$")
    ep_case(dict(moe1, num_local_experts=6), ("ep",), (4,), ValueError, "^6 experts do not divide ep=4$")
    ep_case(moe1, ("ep",), (2,), ValueError, "stack_expert_weights", stacked=False)
    ep_case(dict(oss, num_hidden_layers=1, layer_types=("sliding_attention",)), ("ep",), (2,), NotImplementedError,
            "^fused expert stacks", stacked=False)

    def quantize_experts(params):
        for layer in params["layers"]:
            W1, W3, W2 = layer["experts_stacked"]
            q = {"q": W1, "scale": W1}
            layer["experts_stacked"] = (q, W3, W2)
        return params

    ep_case(moe1, ("ep",), (2,), NotImplementedError, "^quantized expert stacks do not train; dequantize first$",
            edit=quantize_experts)
    ep_case(moe1, ("ep",), (2,), ValueError, "^zero1 needs a 'dp' axis in the ep mesh$", fn="step")
    six = dict(MOE, num_local_experts=6)
    layer = tllama.init_params(tllama.ModelConfig(**six), seed=0, dtype=torch.float32)["layers"][0]
    stacks = tllama.expert_stacks(layer)
    x = np.zeros((1, 3, 32), np.float32)
    m4 = tm(("ep",), (4,))
    both(ValueError, "^6 experts do not divide 4 devices$",
         lambda: tmoe.expert_parallel_ffn(m4, tllama.ModelConfig(**six), *tmoe.shard_experts(m4, layer),
                                          torch.from_numpy(x)),
         lambda: jmoe.expert_parallel_ffn(jax_mesh(("ep",), (4,)), jcfg_of(six), jnp.asarray(layer["moe_gate"].numpy()),
                                          None, *(jnp.asarray(w.numpy()) for w in stacks), jnp.asarray(x)))


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    _rank_body(Path(sys.argv[1]))
