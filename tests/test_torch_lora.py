"""Port vs JAX: LoRA training (shardmerge_tpu_torch/parallel/lora.py against
shardmerge_tpu/parallel/lora.py), after tests/test_lora.py: identity at
init, A drawn bit for bit as JAX draws it, only the adapters train, QLoRA
on int8 and int4 bases along JAX's trajectory (losses within 1e-5 relative,
adapters within relL2 1e-4), the PEFT export fusing back through the port's
fuse-lora, and JAX's validation errors. The multi-rank LoRA steps are in
tests/test_torch_train.py."""

import numpy as np
import pytest
import torch

from shardmerge_tpu_torch.models import llama as tllama
from shardmerge_tpu_torch.models import quant as tquant
from shardmerge_tpu_torch.parallel import lora as tlora
from shardmerge_tpu_torch.parallel import mesh as tmesh
from shardmerge_tpu_torch.parallel.train import tree_flatten

# JAX's tests/test_lora.py _cfg
HF = {"vocab_size": 64, "hidden_size": 32, "intermediate_size": 48, "num_hidden_layers": 2,
      "num_attention_heads": 4, "num_key_value_heads": 2, "max_position_embeddings": 64, "model_type": "llama"}
# the wider config of the int4 base: K/2 of every projection a multiple of 16
HF4 = {**HF, "hidden_size": 64, "intermediate_size": 96}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def one_device():
    return tmesh.make_mesh(("dp", "tp"), shape=(1, 1), device="cpu")


def cfg_of(hf=HF):
    return tllama.ModelConfig.from_hf_config(hf)


def batch(cfg, seed=0, B=4, T=9):
    return torch.from_numpy(np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, T + 1)))


def quantized(params, bits):
    return {**params, "layers": [{k: (tquant.quantize(v, bits) if k in tllama.QUANTIZABLE else v)
                                  for k, v in layer.items()} for layer in params["layers"]]}


def test_lora_init_is_identity():
    """B = 0: the merged leaves are the base's bits and the logits equal."""
    cfg = cfg_of()
    params = tllama.init_params(cfg, seed=0, dtype=torch.float32)
    lora = tlora.lora_init(one_device(), params, rank=4, seed=3)
    merged = tlora.merge_lora(params, lora, 1.0)
    for i, layer in enumerate(params["layers"]):
        for name in ("q_proj", "down_proj"):
            assert torch.equal(merged["layers"][i][name], layer[name])
    ids = batch(cfg)[:, :-1]
    with torch.no_grad():
        assert torch.equal(tllama.forward_train(merged, cfg, ids), tllama.forward_train(params, cfg, ids))


def test_adapters_are_drawn_as_jax_draws_them():
    """lora_init over int8 and raw bases: every A bit-equal to JAX's
    lora_init for the same seed (jax.random key / split / uniform), B zero,
    the shapes (r, in) and (out, r)."""
    import jax

    from shardmerge_tpu.parallel import lora as jlora
    from shardmerge_tpu.parallel import mesh as jmesh

    cfg = cfg_of()
    params = tllama.init_params(cfg, seed=1, dtype=torch.float32)
    mesh = jmesh.make_mesh(("dp", "tp"), devices=jax.devices()[:1], shape=(1, 1))
    for base in (params, quantized(params, 8)):
        jbase = jax.tree_util.tree_map(lambda t: jax.numpy.asarray(t.numpy()), base)
        want = jlora.lora_init(mesh, jbase, rank=4, seed=17)
        got = tlora.lora_init(one_device(), base, rank=4, seed=17)
        for path, g, w in zip(tree_flatten(got)[0], tree_flatten(got)[1], jax.tree_util.tree_leaves(want)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=str(path))
        assert got["layers"][1]["down_proj"]["A"].shape == (4, 48)
        assert got["layers"][1]["down_proj"]["B"].shape == (32, 4)


def test_lora_trains_only_adapters():
    """Two falling steps; the base stays bit-identical; A moves; the
    optimizer's moments are adapter-sized."""
    cfg = cfg_of()
    params = tllama.init_params(cfg, seed=1, dtype=torch.float32)
    init, step = tlora.make_lora_train_step(one_device(), cfg, rank=4, learning_rate=1e-2, seed=5)
    state = init(params)
    a0 = state["lora"]["layers"][0]["q_proj"]["A"].clone()
    b = batch(cfg, seed=2)
    state, loss0 = step(state, b)
    state, loss1 = step(state, b)
    assert np.isfinite(float(loss0)) and float(loss1) < float(loss0)
    for before, after in zip(tree_flatten(params)[1], tree_flatten(state["params"])[1]):
        assert torch.equal(before, after)
    assert not torch.equal(a0, state["lora"]["layers"][0]["q_proj"]["A"])
    n_lora = len(tree_flatten(state["lora"])[1])
    adam = state["opt_state"][0]
    assert len(adam["mu"]) == len(adam["nu"]) == n_lora == 2 * 2 * 7


@pytest.mark.parametrize("bits", [None, 8, 4], ids=["raw", "int8", "int4"])
def test_qlora_follows_jax_trajectory(bits):
    """make_lora_train_step against JAX's on one device, f32 activations,
    adapters on q_proj and v_proj (so the untargeted quantized projections
    carry the gradient upstream: Int4Matmul's backward for int4): three
    steps' losses within 1e-5 relative, the adapters within relL2 1e-4
    (measured 3.6e-07 raw, 5.5e-06 int8, 2.5e-05 int4; losses 1.2e-07 at most); the base stays
    quantized."""
    import jax
    import jax.numpy as jnp

    from shardmerge_tpu.parallel import lora as jlora
    from shardmerge_tpu.parallel import mesh as jmesh

    hf = HF4 if bits == 4 else HF
    cfg = cfg_of(hf)
    from shardmerge_tpu.models import llama as jllama

    jcfg = jllama.ModelConfig.from_hf_config(hf)
    params = tllama.init_params(cfg, seed=11, dtype=torch.float32)
    base = params if bits is None else quantized(params, bits)
    targets = ("q_proj", "v_proj")
    jinit, jstep = jlora.make_lora_train_step(jmesh.make_mesh(("dp", "tp"), devices=jax.devices()[:1], shape=(1, 1)),
                                              jcfg, rank=4, learning_rate=1e-2, seed=13, targets=targets)
    jstate = jinit(jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), base))
    init, step = tlora.make_lora_train_step(one_device(), cfg, rank=4, learning_rate=1e-2, seed=13, targets=targets)
    state = init(base)
    losses, want = [], []
    for s in range(3):
        b = batch(cfg, seed=14 + s)
        jstate, jloss = jstep(jstate, jnp.asarray(b.numpy()))
        state, loss = step(state, b)
        want.append(float(jloss))
        losses.append(float(loss))
    np.testing.assert_allclose(losses, want, rtol=1e-5)
    for got, w in zip(tree_flatten(state["lora"])[1], jax.tree_util.tree_leaves(jstate["lora"])):
        assert rel_l2(got.numpy(), np.asarray(w)) <= 1e-4
    if bits is not None:
        assert isinstance(state["params"]["layers"][0]["k_proj"], dict)


def test_lora_remat_is_bit_equal():
    cfg = cfg_of()
    out = []
    for remat in (False, True):
        init, step = tlora.make_lora_train_step(one_device(), cfg, rank=4, learning_rate=1e-2, seed=17, remat=remat)
        state, loss = step(init(tllama.init_params(cfg, seed=15, dtype=torch.float32)), batch(cfg, seed=18))
        out.append((loss, state["lora"]["layers"][0]["q_proj"]["B"]))
    assert torch.equal(out[0][0], out[1][0]) and torch.equal(out[0][1], out[1][1])


def test_lora_export_fuses_back(tmp_path):
    """Train on a transformers Llama checkpoint, export with lora_to_peft,
    fuse with the port's fuse_lora: the fused checkpoint equals merge_lora
    of the trained state (rtol 1e-5, atol 1e-6, JAX's test's gates)."""
    from transformers import LlamaConfig, LlamaForCausalLM

    from shardmerge_tpu_torch.models.loader import load_params
    from shardmerge_tpu_torch.tools.fuse_lora import fuse_lora

    torch.manual_seed(3)
    config = LlamaConfig(vocab_size=64, hidden_size=32, intermediate_size=48, num_hidden_layers=2,
                         num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64,
                         tie_word_embeddings=False)
    base_dir = tmp_path / "base"
    LlamaForCausalLM(config).eval().to(torch.float32).save_pretrained(str(base_dir), safe_serialization=True)
    cfg = tllama.ModelConfig.from_pretrained(base_dir)
    params = load_params(base_dir, cfg, dtype=torch.float32)
    init, step = tlora.make_lora_train_step(one_device(), cfg, rank=4, learning_rate=1e-2, seed=19)
    state = init(params)
    for s in range(2):
        state, _ = step(state, batch(cfg, seed=20 + s))
    summary = tlora.lora_to_peft(state["lora"], tmp_path / "adapter", rank=4, alpha=4.0, base_model=str(base_dir))
    assert summary["tensors"] == 2 * 7
    fuse_lora(base_dir, tmp_path / "adapter", tmp_path / "fused")
    merged = tlora.merge_lora(state["params"], state["lora"], 1.0)
    fused = load_params(tmp_path / "fused", cfg, dtype=torch.float32)
    for i in range(cfg.num_hidden_layers):
        for name in ("q_proj", "o_proj", "down_proj"):
            np.testing.assert_allclose(fused["layers"][i][name].numpy(), merged["layers"][i][name].numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=f"layer {i} {name}")


def test_lora_checkpoint_with_an_int4_base_round_trips(tmp_path):
    """One device: a QLoRA state on a packed-int4 base saved after one
    step holds the base's bytes whole; restored onto a template built from
    another base it resumes with the uninterrupted run's losses bit for
    bit."""
    from shardmerge_tpu_torch.io.safetensors_io import SafeTensorsReader
    from shardmerge_tpu_torch.parallel import checkpoint as tck

    cfg = cfg_of(HF4)
    base = quantized(tllama.init_params(cfg, seed=0, dtype=torch.float32), 4)
    data = batch(cfg, seed=2)
    init, step = tlora.make_lora_train_step(one_device(), cfg, rank=4, learning_rate=1e-2, seed=1)
    state, _ = step(init(base), data)
    tck.save_train_state(tmp_path, state, step=1)
    ref = []
    for _ in range(2):
        state, loss = step(state, data)
        ref.append(loss)
    with SafeTensorsReader(tmp_path / "train_state.safetensors") as r:
        for path, leaf in zip(*tree_flatten(base)):
            assert torch.equal(r.get_tensor("params/" + "/".join(map(str, path)), copy=True), leaf), path
    other = quantized(tllama.init_params(cfg, seed=7, dtype=torch.float32), 4)
    restored, at = tck.restore_train_state(tmp_path, init(other))
    assert at == 1
    for want in ref:
        restored, loss = step(restored, data)
        assert torch.equal(loss, want)


def test_lora_validation_errors_are_jax_s():
    """The messages of JAX's lora_init and lora_to_peft."""
    import jax

    from shardmerge_tpu.parallel import lora as jlora
    from shardmerge_tpu.parallel import mesh as jmesh

    cfg = cfg_of()
    params = tllama.init_params(cfg, seed=21, dtype=torch.float32)
    jparams = jax.tree_util.tree_map(lambda t: jax.numpy.asarray(t.numpy()), params)
    jm = jmesh.make_mesh(("dp", "tp"), devices=jax.devices()[:1], shape=(1, 1))
    for kwargs in ({"rank": 0}, {"rank": 4, "targets": ("nonexistent_proj",)}):
        with pytest.raises(ValueError) as want:
            jlora.lora_init(jm, jparams, **kwargs)
        with pytest.raises(ValueError) as got:
            tlora.lora_init(one_device(), params, **kwargs)
        assert str(got.value) == str(want.value)
    odd = {"layers": [{"shared_gate_proj": {"A": torch.zeros(1, 2), "B": torch.zeros(2, 1)}}]}
    with pytest.raises(ValueError, match="no HF module mapping for adapted leaf 'shared_gate_proj'"):
        tlora.lora_to_peft(odd, "unused", rank=1, alpha=1.0)
