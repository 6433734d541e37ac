"""Port vs JAX: pipeline-parallel training (shardmerge_tpu_torch/parallel/
pipeline.py ``stack_stages``, ``pipeline_forward_train``, ``make_pp_loss``,
parallel/train.py ``make_pp_train_step``, parallel/comm.py's point-to-point
transfers, a pipeline's checkpoint and models/convert.py's un-stacking)
against shardmerge_tpu/parallel/pipeline.py and ``make_pp_train_step`` on
JAX's virtual CPU devices.

One launch of 4 gloo ranks (tests/torch_ranks.py) starts with the module's
first test that asks for it and runs every mesh in turn: pp = 4, (dp, pp) =
(2, 2) and (pp, tp) = (2, 2), the quantized stacks, the checkpoint across
layouts and the mesh's rank order; it runs while the parent computes JAX's
references, and the ranks import no JAX. Gates (f32): logits relL2 <= 1e-5,
every gradient <= 1e-4 a leaf, three train steps' losses within 1e-5
relative and updates within relL2 1e-4; quantized stacks within JAX's own
rtol 2e-2, atol 4e-3."""

import json
import pickle
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from shardmerge_tpu_torch.models import llama as tllama
from shardmerge_tpu_torch.models import quant as tquant
from shardmerge_tpu_torch.models.convert import params_from_jax
from shardmerge_tpu_torch.parallel import checkpoint as tck
from shardmerge_tpu_torch.parallel import mesh as tmesh
from shardmerge_tpu_torch.parallel import optim
from shardmerge_tpu_torch.parallel import pipeline as tpipe
from shardmerge_tpu_torch.parallel import train as ttrain

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from tests.test_torch_train import FAMILIES, family_params, rel_l2, tokens  # noqa: E402

# JAX's tests/test_parallel.py _pp_cfg(4), as an HF config
PP = {"vocab_size": 64, "hidden_size": 32, "intermediate_size": 48, "num_hidden_layers": 4,
      "num_attention_heads": 4, "num_key_value_heads": 2, "max_position_embeddings": 64, "model_type": "llama"}
_GEMMA3 = {"model_type": "gemma3_text", "vocab_size": 128, "hidden_size": 64, "intermediate_size": 128,
           "num_hidden_layers": 4, "num_attention_heads": 4, "num_key_value_heads": 2,
           "max_position_embeddings": 256, "rms_norm_eps": 1e-5, "head_dim": 16,
           "hidden_activation": "gelu_pytorch_tanh", "query_pre_attn_scalar": 16, "sliding_window": 4,
           "sliding_window_pattern": 2, "rope_theta": 1000000.0, "rope_local_base_freq": 10000.0,
           "rope_scaling": {"rope_type": "linear", "factor": 8.0}}
# the eight families and the mesh each runs on: (axes, shape, stages)
PP4, DPPP, PPTP = (("pp",), (4,), 4), (("dp", "pp"), (2, 2), 2), (("pp", "tp"), (2, 2), 2)
FAMILY_RUNS = {
    "llama": ({**FAMILIES["llama"], "num_hidden_layers": 4}, PP4),
    "gemma2": ({**FAMILIES["gemma2"], "num_hidden_layers": 4}, PP4),
    "gemma3": (_GEMMA3, PP4),
    "mixtral": ({**FAMILIES["mixtral"], "num_hidden_layers": 4}, PP4),
    "gpt_oss": ({**FAMILIES["gpt_oss"], "num_hidden_layers": 4, "layer_types": ["sliding_attention",
                                                                              "full_attention"] * 2}, PP4),
    "deepseek_v3": (FAMILIES["deepseek_v3"], DPPP),
    "llama4": (FAMILIES["llama4"], DPPP),
    "olmo2": (FAMILIES["olmo2"], PPTP),
}
# (axes, shape, stages, zero1, tied embedding)
TRAIN_MESHES = {"pp4": (("pp",), (4,), 4, False, False), "dp2_pp2": (("dp", "pp"), (2, 2), 2, True, False),
                "pp2_tp2": (("pp", "tp"), (2, 2), 2, False, False), "pp4_tied": (("pp",), (4,), 4, False, True)}
QUANT = [(kind, bits, mesh) for kind in ("dense", "experts") for bits in (8, 4) for mesh in ("pp4", "pp2_tp2")]
MICRO = 2


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def hf_cfg(hf):
    from shardmerge_tpu.models import llama as jllama

    return jllama.ModelConfig.from_hf_config(hf), tllama.ModelConfig.from_hf_config(hf)


def to_jax(tree):
    import jax
    import jax.numpy as jnp

    return jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), tree)


def jax_mesh(axes, shape):
    import jax

    from shardmerge_tpu.parallel.mesh import make_mesh

    return make_mesh(axes, devices=jax.devices()[:int(np.prod(shape))], shape=shape)


def named(tree) -> dict:
    """{"layers/3/q_proj": numpy} of a port tree."""
    paths, leaves = ttrain.tree_flatten(tree)
    return {"/".join(map(str, p)): np.asarray(v.detach().to(torch.float32).numpy()) for p, v in zip(paths, leaves)}


def jax_named(tree, n_tp=1) -> dict:
    import jax

    return named(params_from_jax(jax.tree_util.tree_map(np.asarray, tree), n_tp=n_tp))


def quant_params(kind: str, bits: int):
    """JAX's quantized-stack tests' trees: _pp_cfg (4 heads, 4 KV heads) with
    every projection and the embedding quantized, or the expert variant's
    experts quantized."""
    hf = {**PP, "num_key_value_heads": 4}
    if kind == "experts":
        hf = {**hf, "model_type": "mixtral", "num_local_experts": 4, "num_experts_per_tok": 2}
    cfg = tllama.ModelConfig.from_hf_config(hf)
    params = tllama.init_params(cfg, seed=5, dtype=torch.float32)
    proj = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj")
    if kind == "dense":
        params = {**params, "embed_tokens": tquant.quantize(params["embed_tokens"], bits),
                  "layers": [{k: (tquant.quantize(v, bits) if k in proj else v) for k, v in layer.items()}
                             for layer in params["layers"]]}
    else:
        params = {**params, "layers": [{**layer, "experts": [{k: tquant.quantize(w, bits) for k, w in ex.items()}
                                                              for ex in layer["experts"]]}
                                       for layer in params["layers"]]}
    return hf, params


def train_hf(tied: bool) -> dict:
    return {**PP, "tie_word_embeddings": tied}


def jax_train_data(tied: bool = False):
    """JAX's test_pp_train_step_descends_and_zero1_shards_moments data: its
    init_params(PRNGKey(50)) in f32 (carried into the port; ``tied``: the
    config without an lm_head) and its randint(PRNGKey(51)) (4, 10) batch."""
    import jax
    import jax.numpy as jnp

    from shardmerge_tpu.models import llama as jllama

    jcfg, _ = hf_cfg(train_hf(tied))
    params = jllama.init_params(jcfg, jax.random.PRNGKey(50), dtype=jnp.float32)
    batch = jax.random.randint(jax.random.PRNGKey(51), (4, 10), 0, jcfg.vocab_size)
    return params_from_jax(jax.tree_util.tree_map(np.asarray, params)), np.asarray(batch).tolist()


def train_tx():
    return optim.chain(optim.clip_by_global_norm(0.5), optim.adamw(optim.cosine_decay_schedule(1e-2, 4)))


# -- ranks ---------------------------------------------------------------------------


def _whole_grads(mesh, cfg, stage, grads) -> dict:
    """The stage's gradients whole (joined over tp, summed over dp), by
    name, on the ranks at dp = tp = 0; None on the others."""
    lay = tpipe.stage_layout(mesh, cfg, stage)
    out = {}
    for i, (p, g) in enumerate(zip(lay.paths, grads)):
        g = lay.gather_tp(i, g)
        if lay.dp > 1:
            g = lay.dp_comm.all_reduce(g)
        out["/".join(map(str, p))] = g.numpy()
    keep = mesh.coords.get("dp", 0) == 0 and mesh.coords.get("tp", 0) == 0
    return out if keep else None


def _whole_params(state) -> dict:
    lay = state.layout
    leaves = ttrain.tree_flatten(state["params"])[1]
    return {"/".join(map(str, p)): lay.gather("trained", i, v).numpy() for i, (p, v) in enumerate(zip(lay.paths,
                                                                                                      leaves))}


def _family_run(job, name, res):
    hf, (axes, shape, n_stages) = job["families"][name]
    cfg = tllama.ModelConfig.from_hf_config(hf)
    params = pickle.loads((Path(job["dir"]) / f"{name}.pkl").read_bytes())
    batch = torch.from_numpy(np.asarray(job["batch"][name], np.int64))
    mesh = tmesh.make_mesh(tuple(axes), shape=tuple(shape), device="cpu")
    stage = tpipe.stack_stages(mesh, params, n_stages, tp="tp" in axes, cfg=cfg)
    with torch.no_grad():
        logits = tpipe.pipeline_forward_train(mesh, cfg, stage, batch[:, :-1], MICRO)
    leaves = [v.requires_grad_(True) for v in ttrain.tree_flatten(stage)[1]]
    loss = tpipe.make_pp_loss(mesh, cfg, MICRO)(ttrain.tree_unflatten(stage, leaves), batch)
    grads = torch.autograd.grad(loss, leaves)
    res[f"family/{name}"] = {"logits": None if logits is None else logits.numpy(), "loss": float(loss),
                             "grads": _whole_grads(mesh, cfg, stage, grads)}


def _train_run(job, key, res):
    axes, shape, n_stages, zero1, tied = TRAIN_MESHES[key]
    cfg = tllama.ModelConfig.from_hf_config(train_hf(tied))
    params = pickle.loads((Path(job["dir"]) / f"train{'_tied' * tied}.pkl").read_bytes())
    batch = torch.from_numpy(np.asarray(job["batch"]["train"], np.int64))
    mesh = tmesh.make_mesh(axes, shape=shape, device="cpu")
    init, step = ttrain.make_pp_train_step(mesh, cfg, MICRO, learning_rate=1e-2, remat=True, zero1=zero1,
                                           master_fp32=True, tx=train_tx())
    state = init(tpipe.stack_stages(mesh, params, n_stages, tp="tp" in axes, cfg=cfg))
    pp = mesh.comm("pp")
    losses, p2p = [], []
    for _ in range(3):
        before = list(pp.stats.get("p2p", [0, 0, 0.0]))
        state, loss = step(state, batch)
        losses.append(float(loss))
        after = pp.stats["p2p"]
        p2p.append([after[0] - before[0], after[1] - before[1]])
    res[f"train/{key}"] = {"losses": losses, "params": _whole_params(state), "p2p": p2p,
                           "coords": mesh.coords}


def _quant_run(job, kind, bits, key, res):
    axes, shape, n_stages = TRAIN_MESHES[key][:3]
    hf, params = quant_params(kind, bits)
    cfg = tllama.ModelConfig.from_hf_config(hf)
    batch = torch.from_numpy(np.asarray(job["batch"]["quant"], np.int64))
    mesh = tmesh.make_mesh(axes, shape=shape, device="cpu")
    stage = tpipe.stack_stages(mesh, params, n_stages, tp="tp" in axes, cfg=cfg)
    with torch.no_grad():
        logits = tpipe.pipeline_forward_train(mesh, cfg, stage, batch, MICRO)
    res[f"quant/{kind}/{bits}/{key}"] = None if logits is None else logits.numpy()


def _ckpt_run(job, res):
    """A pp = 2 state saved at step 2 (a ("rep", "pp") = (2, 2) mesh: two
    pipelines), the uninterrupted losses of steps 3-4; restored on (dp, tp)
    = (1, 2) (a ("rep", "dp", "tp") = (2, 1, 2) mesh) and run on; that
    state saved again and restored on pp = 2."""
    d = Path(job["dir"])
    cfg = tllama.ModelConfig.from_hf_config(PP)
    params = pickle.loads((d / "train.pkl").read_bytes())
    batch = torch.from_numpy(np.asarray(job["batch"]["train"], np.int64))
    pp_mesh = tmesh.make_mesh(("rep", "pp"), shape=(2, 2), device="cpu")
    init, step = ttrain.make_pp_train_step(pp_mesh, cfg, MICRO, learning_rate=1e-2, tx=train_tx())
    state = init(tpipe.stack_stages(pp_mesh, params, 2))
    for _ in range(2):
        state, _ = step(state, batch)
    tck.save_train_state(d / "ckpt_pp", state, step=2)
    ref = []
    for _ in range(2):
        state, loss = step(state, batch)
        ref.append(float(loss))
    tp_mesh = tmesh.make_mesh(("rep", "dp", "tp"), shape=(2, 1, 2), device="cpu")
    init_tp, step_tp = ttrain.make_train_step(tp_mesh, cfg, learning_rate=1e-2, tx=train_tx())
    restored, at = tck.restore_train_state(d / "ckpt_pp", init_tp(params))
    tck.save_train_state(d / "ckpt_tp", restored, step=at)
    on_tp = []
    for _ in range(2):
        restored, loss = step_tp(restored, batch)
        on_tp.append(float(loss))
    back, at_back = tck.restore_train_state(d / "ckpt_tp", init(tpipe.stack_stages(pp_mesh, params, 2)))
    on_pp = []
    for _ in range(2):
        back, loss = step(back, batch)
        on_pp.append(float(loss))
    res["ckpt"] = {"at": [at, at_back], "ref": ref, "tp": on_tp, "pp": on_pp}


def _mesh_order(res):
    """Each rank's coordinates and its pp line's global ranks on (dp, pp,
    tp) = (1, 2, 2) and (2, 2, 1)."""
    import torch.distributed as dist

    out = {}
    for shape in ((1, 2, 2), (2, 2, 1)):
        m = tmesh.make_mesh(("dp", "pp", "tp"), shape=shape, device="cpu")
        pp = m.comm("pp")
        out[str(shape)] = {"coords": m.coords, "pp_line": dist.get_process_group_ranks(pp.group),
                           "position": pp.position}
    res["mesh"] = out


def _rank_body(out_dir: Path) -> None:
    import torch.distributed as dist

    job = json.loads((out_dir / "job.json").read_text())
    res = {}
    _mesh_order(res)
    for name in job["families"]:
        _family_run(job, name, res)
    for key in TRAIN_MESHES:
        _train_run(job, key, res)
    for kind, bits, key in QUANT:
        _quant_run(job, kind, bits, key, res)
    _ckpt_run(job, res)
    (out_dir / f"rank{dist.get_rank()}.pkl").write_bytes(pickle.dumps(res))


@pytest.fixture(scope="module")
def launch(tmp_path_factory):
    """The 4-rank launch, started at once; its results read on first use."""
    from . import torch_ranks

    d = tmp_path_factory.mktemp("pp_ranks")
    batches, families = {}, {}
    for i, (name, (hf, mesh)) in enumerate(FAMILY_RUNS.items()):
        cfg = tllama.ModelConfig.from_hf_config(hf)
        params = family_params(cfg, seed=20 + i)
        for layer in params["layers"]:
            if "o_bias" in layer:  # JAX's block_train leaves GPT-OSS's o_proj bias out
                layer["o_bias"] = torch.zeros_like(layer["o_bias"])
        (d / f"{name}.pkl").write_bytes(pickle.dumps(params))
        batches[name] = tokens(cfg.vocab_size, (4, 10), seed=40 + i).tolist()
        families[name] = (hf, mesh)
    train_params, batches["train"] = jax_train_data()
    tied_params, _ = jax_train_data(tied=True)
    (d / "train.pkl").write_bytes(pickle.dumps(train_params))
    (d / "train_tied.pkl").write_bytes(pickle.dumps(tied_params))
    batches["quant"] = tokens(64, (4, 7), seed=6).tolist()
    (d / "job.json").write_text(json.dumps({"dir": str(d), "families": families, "batch": batches}))
    procs = torch_ranks.start([str(Path(__file__).resolve()), str(d)], 4, d / "logs")
    state = {"dir": d, "procs": procs, "results": None, "batch": batches, "train_params": train_params,
             "tied_params": tied_params}
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


# -- no ranks: the layer assignment, the refusals, the conversion ---------------------


def _jax_assignment(jparams, n_stages, **kw):
    """(prefix, layers per stage) of JAX's stack_stages."""
    import jax

    from shardmerge_tpu.parallel.pipeline import stack_stages

    out = stack_stages(jax_mesh(("pp",), (n_stages,)), jparams, n_stages, **kw)
    blocks = out["blocks"]
    slots = blocks.get("period_slots")
    run = slots[0] if slots else blocks
    per = jax.tree_util.tree_leaves(run)[0].shape[1] * (len(slots) if slots else 1)
    return len(out.get("prefix_blocks", [])), per


def _port_assignment(params, n_stages, **kw):
    """Each stage's global layers under the port's stack_stages."""
    return [sorted(tpipe.stack_stages(tmesh.Mesh(("pp",), (n_stages,), r, "cpu"), params, n_stages,
                                      **kw)["layers"]) for r in range(n_stages)]


def _layered(cfg, n):
    import dataclasses

    return dataclasses.replace(cfg, num_hidden_layers=n)


@pytest.mark.parametrize("case", ["llama8_p2", "llama8_p4", "deepseek_prefix", "deepseek_prefix_59",
                                  "llama4_interleaved"])
def test_stack_stages_assigns_layers_as_jax(case):
    """Each stage's layers under the port's stack_stages are JAX's: stage r
    holds [n_prefix + r per, n_prefix + (r + 1) per), stage 0 also the
    dense prefix (auto-detected, or widened by n_prefix_layers so a
    59-style count divides), Llama-4's interleave by whole periods."""
    hf, n_stages, kw = {
        "llama8_p2": ({**PP, "num_hidden_layers": 8}, 2, {}),
        "llama8_p4": ({**PP, "num_hidden_layers": 8}, 4, {}),
        "deepseek_prefix": ({**FAMILIES["deepseek_v3"], "num_hidden_layers": 5}, 2, {}),
        # 1 dense + 3 MoE layers: 3 does not divide 2 stages; 2 leading layers on stage 0 make it
        "deepseek_prefix_59": ({**FAMILIES["deepseek_v3"], "num_hidden_layers": 4}, 2, {"n_prefix_layers": 2}),
        "llama4_interleaved": ({**FAMILIES["llama4"], "num_hidden_layers": 8}, 2, {}),
    }[case]
    _, tcfg = hf_cfg(hf)
    params = tllama.init_params(tcfg, seed=1, dtype=torch.float32)
    n_prefix, per = _jax_assignment(to_jax(params), n_stages, **kw)
    got = _port_assignment(params, n_stages, **kw)
    want = [list(range(n_prefix)) * (r == 0) + list(range(n_prefix + r * per, n_prefix + (r + 1) * per))
            for r in range(n_stages)]
    assert got == want
    assert sum(len(s) for s in got) == tcfg.num_hidden_layers


def test_stack_stages_refusals_are_jax_messages():
    """JAX's refusals with JAX's messages: stages that do not divide the
    layers (with the prefix hint where one applies), a stage that cuts a
    kind period, a heterogeneous remainder, a quantized dict holding a
    non-array; and JAX raises the same for each."""
    import jax

    from shardmerge_tpu.parallel.pipeline import stack_stages as jstack

    cases = []
    _, cfg = hf_cfg(PP)
    params = tllama.init_params(cfg, seed=0, dtype=torch.float32)
    cases.append((params, 8, {}, ValueError, "8 pipeline stages do not evenly divide 4 pipelined layers$"))
    deep = tllama.init_params(tllama.ModelConfig.from_hf_config({**FAMILIES["deepseek_v3"], "num_hidden_layers": 4}),
                              seed=0, dtype=torch.float32)
    cases.append((deep, 2, {}, ValueError, r"do not evenly divide 3 pipelined layers \(replicate more leading"))
    cases.append((deep, 2, {"n_prefix_layers": 0}, ValueError, "are heterogeneous"))
    l4 = tllama.init_params(tllama.ModelConfig.from_hf_config(FAMILIES["llama4"]), seed=0, dtype=torch.float32)
    cases.append((l4, 4, {}, ValueError, "does not divide the layer-kind period 2"))
    broken = tllama.init_params(cfg, seed=2, dtype=torch.float32)
    for layer in broken["layers"]:
        layer["q_proj"] = {"q": layer["q_proj"], "scale": 1.0}
    cases.append((broken, 4, {}, NotImplementedError, "quantized-dict"))
    for tree, n_stages, kw, err, match in cases:
        with pytest.raises(err, match=match):
            tpipe.stack_stages(tmesh.Mesh(("pp",), (n_stages,), 0, "cpu"), tree, n_stages, **kw)
        jtree = jax.tree_util.tree_map(lambda t: t if isinstance(t, float) else np.asarray(t.numpy()), tree)
        with pytest.raises(err, match=match):
            jstack(jax_mesh(("pp",), (n_stages,)), jtree, n_stages, **kw)


def test_forward_refusals_are_jax_messages():
    """pipeline_forward_train's refusals before any rank is reached: tp that
    does not divide the KV heads (JAX's test_pipeline_tp_rejects_indivisible_
    heads), a batch the microbatches do not divide, a microbatch dp does not
    divide; make_pp_train_step's zero1 without a dp axis."""
    _, cfg = hf_cfg({**PP, "num_hidden_layers": 2})
    params = tllama.init_params(cfg, seed=0, dtype=torch.float32)
    mesh = tmesh.Mesh(("pp", "tp"), (2, 4), 0, "cpu")
    stage = tpipe.stack_stages(mesh, params, 2, tp=True, cfg=cfg)
    with pytest.raises(ValueError, match=r"^tp=4 must evenly divide heads/kv-heads/ffn \(4/2/48\)$"):
        tpipe.pipeline_forward_train(mesh, cfg, stage, torch.zeros((4, 5), dtype=torch.int64), 2)
    pp = tmesh.Mesh(("pp",), (2,), 0, "cpu")
    with pytest.raises(ValueError, match="^2 microbatches do not evenly divide batch 3$"):
        tpipe.pipeline_forward_train(pp, cfg, tpipe.stack_stages(pp, params, 2), torch.zeros((3, 5),
                                                                                              dtype=torch.int64), 2)
    dp = tmesh.Mesh(("dp", "pp"), (2, 2), 0, "cpu")
    with pytest.raises(ValueError, match=r"^dp=2 must evenly divide the microbatch size 1 \(batch 2 / 2 "):
        tpipe.pipeline_forward_train(dp, cfg, tpipe.stack_stages(dp, params, 2), torch.zeros((2, 5),
                                                                                              dtype=torch.int64), 2)
    with pytest.raises(ValueError, match="^zero1 needs a 'dp' axis in the pipeline mesh$"):
        ttrain.make_pp_train_step(pp, cfg, 2, zero1=True)
    with pytest.raises(ValueError, match="needs cfg="):
        tpipe.stack_stages(mesh, params, 2, tp=True)


@pytest.mark.parametrize("case", ["plain", "experts", "prefix", "period_slots", "tp_int4", "tp_int4_experts",
                                  "tp_llama4"])
def test_params_from_jax_unstacks_jax_stage_trees(case):
    """params_from_jax of a JAX stack_stages tree (numpy) equals the
    unpipelined conversion bit for bit: stacked blocks, expert lists,
    DeepSeek's prefix, Llama-4's period slots, and under tp = 2 the int4
    row-parallel repack and Llama-4's gate/up permutation undone."""
    import jax

    from shardmerge_tpu.parallel.pipeline import stack_stages as jstack

    n_tp = 2 if case.startswith("tp") else 1
    if case in ("plain", "tp_int4"):
        hf, params = quant_params("dense", 4) if case == "tp_int4" else (PP, None)
    elif case in ("experts", "tp_int4_experts"):
        hf, params = quant_params("experts", 4) if case == "tp_int4_experts" else \
            ({**PP, "model_type": "mixtral", "num_local_experts": 4, "num_experts_per_tok": 2}, None)
    elif case == "prefix":
        hf, params = {**FAMILIES["deepseek_v3"], "num_hidden_layers": 5}, None
    else:
        hf, params = {**FAMILIES["llama4"], "num_hidden_layers": 8}, None
    if params is None:
        params = tllama.init_params(tllama.ModelConfig.from_hf_config(hf), seed=3, dtype=torch.float32)
    jparams = to_jax(params)
    mesh = jax_mesh(("pp", "tp"), (2, 2)) if n_tp > 1 else jax_mesh(("pp",), (2,))
    stacked = jstack(mesh, jparams, 2, tp=n_tp > 1)
    if case == "period_slots":
        assert "period_slots" in stacked["blocks"]
    if case == "prefix":
        assert len(stacked["prefix_blocks"]) == 1
    got = params_from_jax(jax.tree_util.tree_map(np.asarray, stacked), n_tp=n_tp)
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    gp, gl = ttrain.tree_flatten(got)
    wp, wl = ttrain.tree_flatten(want)
    assert gp == wp
    for p, a, b in zip(gp, gl, wl):
        assert a.dtype == b.dtype and torch.equal(a, b), p


# -- ranks, f32, against JAX -------------------------------------------------------


@pytest.mark.parametrize("name", list(FAMILY_RUNS))
def test_family_logits_loss_and_gradients_match_jax_pipeline(launch, name):
    """Each family through the port's pipeline on its mesh (pp = 4; dp x pp
    for DeepSeek-V3's dense prefix and Llama-4's periodic stack; pp x tp for
    OLMo-2's full-vector q/k norm) against JAX's pipeline_forward_train and
    value_and_grad(make_pp_loss) on the same mesh shape: the last stage's
    logits within relL2 1e-5, the loss within 1e-5 relative, every gradient
    (by name, JAX's un-stacked; a tied embedding's two stage parts summed)
    within relL2 1e-4."""
    import jax
    import jax.numpy as jnp

    from shardmerge_tpu.parallel.pipeline import make_pp_loss
    from shardmerge_tpu.parallel.pipeline import pipeline_forward_train as fwd
    from shardmerge_tpu.parallel.pipeline import stack_stages as stack

    hf, (axes, shape, n_stages) = FAMILY_RUNS[name]
    jcfg, _ = hf_cfg(hf)
    d = launch["dir"]
    params = pickle.loads((d / f"{name}.pkl").read_bytes())
    batch = jnp.asarray(np.asarray(launch["batch"][name], np.int32))
    mesh = jax_mesh(axes, shape)
    tp = "tp" in axes
    stacked = stack(mesh, to_jax(params), n_stages, tp=tp, qk_norm_full=tp and jcfg.qk_norm_full)
    loss_fn = make_pp_loss(mesh, jcfg, MICRO)
    want_logits, (want_loss, want_grads) = jax.jit(
        lambda p, b: (fwd(mesh, jcfg, p, b[:, :-1], MICRO), jax.value_and_grad(loss_fn)(p, b)))(stacked, batch)
    want = jax_named(want_grads, n_tp=2 if tp else 1)
    ranks = results(launch)
    got: dict = {}
    for res in ranks:
        r = res[f"family/{name}"]
        assert r["loss"] == pytest.approx(float(want_loss), rel=1e-5)
        if r["logits"] is not None:
            rel = rel_l2(r["logits"], np.asarray(want_logits))
            assert rel <= 1e-5, f"logits relL2 {rel:.2e}"
        for k, g in (r["grads"] or {}).items():
            got[k] = got[k] + g if k in got else g
    assert set(got) == set(want)
    for k, w in want.items():
        if k.endswith("o_bias"):  # JAX's block_train leaves it out (zero gradient); the port's is real
            continue
        if np.linalg.norm(w) > 0:
            assert rel_l2(got[k], w) <= 1e-4, (k, rel_l2(got[k], w))
        else:
            assert not np.any(got[k]), k


@pytest.mark.parametrize("key", list(TRAIN_MESHES))
def test_three_pp_train_steps_match_jax(launch, key):
    """Three make_pp_train_step steps of the small Llama config (JAX's
    _pp_cfg) with remat, master_fp32, the clip_by_global_norm(0.5) +
    adamw(cosine) chain and, on dp x pp, ZeRO-1, against JAX's
    make_pp_train_step on the same mesh shape: losses within 1e-5 relative,
    each leaf's update within relL2 1e-4; tied (no lm_head, pp = 4) the
    embedding's two copies take the same update, the sum of both stages'
    gradients. The p2p record: each step sends MICRO activations forward
    and MICRO gradients back per stage boundary, of mb x T x hidden x 4
    bytes, and tied the first and last stage trade the embedding's
    gradient."""
    import jax
    import jax.numpy as jnp
    import optax

    from shardmerge_tpu.parallel.pipeline import stack_stages
    from shardmerge_tpu.parallel.train import make_pp_train_step

    axes, shape, n_stages, zero1, tied = TRAIN_MESHES[key]
    jcfg, _ = hf_cfg(train_hf(tied))
    mesh = jax_mesh(axes, shape)
    tx = optax.chain(optax.clip_by_global_norm(0.5), optax.adamw(optax.cosine_decay_schedule(1e-2, 4)))
    init, step = make_pp_train_step(mesh, jcfg, MICRO, remat=True, zero1=zero1, master_fp32=True, tx=tx)
    p0 = launch["tied_params" if tied else "train_params"]
    state = init(stack_stages(mesh, to_jax(p0), n_stages, tp="tp" in axes))
    batch = jnp.asarray(np.asarray(launch["batch"]["train"], np.int32))
    want_losses = []
    for _ in range(3):
        state, loss = step(state, batch)
        want_losses.append(float(loss))
    want = jax_named(state["params"], n_tp=2 if "tp" in axes else 1)
    start = named(p0)
    got: dict = {}
    embeds = []
    dp = shape[axes.index("dp")] if "dp" in axes else 1
    mb_bytes = 4 // MICRO // dp * 9 * PP["hidden_size"] * 4
    embed_bytes = PP["vocab_size"] * PP["hidden_size"] * 4
    for res in results(launch):
        r = res[f"train/{key}"]
        np.testing.assert_allclose(r["losses"], want_losses, rtol=1e-5)
        stage = r["coords"]["pp"]
        sends = MICRO * ((stage < n_stages - 1) + (stage > 0))
        trade = tied and stage in (0, n_stages - 1)
        assert r["p2p"] == [[2 * sends + trade, sends * mb_bytes + trade * embed_bytes]] * 3
        if r["coords"].get("dp", 0) == 0 and r["coords"].get("tp", 0) == 0:
            got.update(r["params"])
            if "embed_tokens" in r["params"]:
                embeds.append(r["params"]["embed_tokens"])
    assert len(embeds) == (2 if tied else 1) and all(np.array_equal(e, embeds[0]) for e in embeds)
    assert set(got) == set(want)
    for k, w in want.items():
        assert rel_l2(got[k] - start[k], w - start[k]) <= 1e-4, k


@pytest.mark.parametrize("kind,bits,key", QUANT, ids=[f"{k}-int{b}-{m}" for k, b, m in QUANT])
def test_quantized_stacks_match_jax_pipeline(launch, kind, bits, key):
    """int8/int4 dense projections (and embedding) and expert lists through
    the pipeline, pp = 4 and pp x tp = 2 x 2 (int4 row slices re-packed),
    against JAX's pipeline_forward_train on the same quantized bytes, at
    JAX's own bound for these stacks (rtol 2e-2, atol 4e-3)."""
    import jax.numpy as jnp

    from shardmerge_tpu.models import llama as jllama
    from shardmerge_tpu.parallel.pipeline import pipeline_forward_train, stack_stages

    axes, shape, n_stages = TRAIN_MESHES[key][:3]
    hf, params = quant_params(kind, bits)
    jcfg = jllama.ModelConfig.from_hf_config(hf)
    mesh = jax_mesh(axes, shape)
    ids = jnp.asarray(np.asarray(launch["batch"]["quant"], np.int32))
    want = np.asarray(pipeline_forward_train(mesh, jcfg, stack_stages(mesh, to_jax(params), n_stages,
                                                                      tp="tp" in axes), ids, MICRO))
    outs = [res[f"quant/{kind}/{bits}/{key}"] for res in results(launch)]
    outs = [o for o in outs if o is not None]
    assert len(outs) == (1 if "tp" not in axes else 2)
    for got in outs:
        np.testing.assert_allclose(got, want, rtol=2e-2, atol=4e-3)


def test_pipeline_checkpoint_resumes_on_other_layouts(launch, tmp_path):
    """A pp = 2 train state saved at step 2 resumes with the uninterrupted
    run's losses (1e-5 relative) restored on (dp, tp) = (1, 2) and on one
    device; the (1, 2) state saved again resumes on pp = 2 the same way.
    The file holds the unpipelined names and whole leaves."""
    ranks = results(launch)
    ck = ranks[0]["ckpt"]
    assert ck["at"] == [2, 2]
    for res in ranks:
        np.testing.assert_allclose(res["ckpt"]["tp"], ck["ref"], rtol=1e-5)
        np.testing.assert_allclose(res["ckpt"]["pp"], ck["ref"], rtol=1e-5)
    cfg = tllama.ModelConfig.from_hf_config(PP)
    one = tmesh.make_mesh(("dp", "tp"), shape=(1, 1), device="cpu")
    init, step = ttrain.make_train_step(one, cfg, learning_rate=1e-2, tx=train_tx())
    template = init(launch["train_params"])
    state, at = tck.restore_train_state(launch["dir"] / "ckpt_pp", template)
    assert at == 2
    losses = []
    for _ in range(2):
        state, loss = step(state, torch.from_numpy(np.asarray(launch["batch"]["train"], np.int64)))
        losses.append(float(loss))
    np.testing.assert_allclose(losses, ck["ref"], rtol=1e-5)
    from shardmerge_tpu_torch.io.safetensors_io import SafeTensorsReader

    with SafeTensorsReader(launch["dir"] / "ckpt_pp" / "train_state.safetensors") as r:
        names = set(r.keys())
        assert r.get_tensor("params/layers/3/q_proj").shape == (32, 32)
    assert {"params/layers/0/q_proj", "params/embed_tokens", "params/lm_head", "params/norm"} <= names


def test_mesh_places_ranks_row_major_and_pp_lines_join_stages(launch):
    """make_mesh(("dp", "pp", "tp")): rank d P T + p T + t sits at (d, p,
    t), JAX's row-major order, and mesh.comm("pp") joins the ranks of one
    (d, t) across the stages, its position the stage."""
    for rank, res in enumerate(results(launch)):
        for shape in ((1, 2, 2), (2, 2, 1)):
            D, P, T = shape
            m = res["mesh"][str(shape)]
            d, p, t = rank // (P * T), rank // T % P, rank % T
            assert m["coords"] == {"dp": d, "pp": p, "tp": t}
            assert m["pp_line"] == [d * P * T + q * T + t for q in range(P)]
            assert m["position"] == p


def test_comm_p2p_send_recv_and_sendrecv_count_their_bytes(tmp_path):
    """Comm.send / recv / sendrecv between two gloo ranks: the tensors
    arrive, and the p2p record counts each call and the bytes sent."""
    from . import torch_ranks

    script = tmp_path / "p2p.py"
    script.write_text(
        "import sys, json, torch\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        "from shardmerge_tpu_torch.parallel import mesh as tmesh\n"
        "m = tmesh.make_mesh(('pp',), shape=(2,), device='cpu')\n"
        "c = m.comm('pp')\n"
        "x = torch.arange(6, dtype=torch.float32).reshape(2, 3) + 10 * c.position\n"
        "if c.position == 0:\n"
        "    c.send(x, 1)\n"
        "    got = c.recv(torch.empty(2, 3), 1)\n"
        "else:\n"
        "    got = c.recv(torch.empty(2, 3), 0)\n"
        "    c.send(got * 2, 0)\n"
        "swap = c.sendrecv(x, 1 - c.position)\n"
        "print(json.dumps({'got': got.tolist(), 'swap': swap.tolist(), 'stats': c.stats['p2p'][:2]}))\n")
    res = torch_ranks.launch([str(script)], 2, tmp_path / "logs", timeout=60)
    outs = []
    for rank, (rc, out, err) in enumerate(res):
        assert rc == 0, err[-2000:]
        outs.append(json.loads(out.strip().splitlines()[-1]))
    base = np.arange(6, dtype=np.float32).reshape(2, 3)
    assert np.array_equal(outs[1]["got"], base) and np.array_equal(outs[0]["got"], base * 2)
    assert np.array_equal(outs[0]["swap"], base + 10) and np.array_equal(outs[1]["swap"], base)
    assert outs[0]["stats"] == [3, 48] and outs[1]["stats"] == [3, 48]


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    _rank_body(Path(sys.argv[1]))
