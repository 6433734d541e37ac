"""Port vs JAX: flash-decode attention (shardmerge_tpu_torch/models/
attn_kernels.py against shardmerge_tpu/models/attn_kernels.py).

On the CPU the port's wrapper runs its plain version; the JAX kernel runs in
Pallas interpret mode, as tests/test_attn_kernels.py runs it. The CUDA kernel
itself is held to the plain version on the card (tests/test_torch_cuda.py,
chip_smoke.py). Tolerance: rtol = atol = 2e-5, the JAX suite's for the same
comparison (f32 scores, a different summation order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shardmerge_tpu.models import attn_kernels as jak
from shardmerge_tpu.models import llama as jllama
from shardmerge_tpu_torch.models import attn_kernels as ak
from shardmerge_tpu_torch.models import llama as tllama
from shardmerge_tpu_torch.models.convert import params_from_jax

TOL = dict(rtol=2e-5, atol=2e-5)

# tests/test_attn_kernels.py::_flash_cfg (head_dim 128, the kernel's D)
FLASH_HF = {
    "model_type": "llama",
    "vocab_size": 128,
    "hidden_size": 256,
    "intermediate_size": 256,
    "num_hidden_layers": 2,
    "num_attention_heads": 2,
    "num_key_value_heads": 1,
    "max_position_embeddings": 256,
    "rms_norm_eps": 1e-5,
    "rope_theta": 10000.0,
}


def _inputs(seed, b, kvh, g, d, s, valid):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, kvh, g, d)).astype(np.float32)
    k = jnp.asarray(rng.standard_normal((b, kvh, s, d)).astype(np.float32)).astype(jnp.bfloat16)
    v = jnp.asarray(rng.standard_normal((b, kvh, s, d)).astype(np.float32)).astype(jnp.bfloat16)
    if valid == "holes":  # masked tail + interior holes, as the JAX test
        ok = rng.random((b, s)) > 0.25
        ok[:, s // 2 :] = False
        ok[:, 0] = True
    else:  # only the last few slots of the last block
        ok = np.zeros((b, s), bool)
        ok[:, -7:] = True
    mask = np.where(ok, 0.0, -1e9).astype(np.float32)
    return q, k, v, mask


def _torch(x):
    """numpy / bf16 jax array -> torch tensor, bit for bit."""
    return params_from_jax(np.asarray(x))


@pytest.mark.parametrize(
    "b,kvh,g,d,s,valid",
    [
        (1, 2, 4, 128, 256, "holes"),
        (2, 1, 1, 128, 512, "holes"),
        (1, 4, 2, 256, 128, "holes"),
        (1, 1, 4, 128, 512, "last7"),
    ],
)
def test_plain_version_matches_jax_kernel(b, kvh, g, d, s, valid):
    q, k, v, mask = _inputs(b * 1000 + s, b, kvh, g, d, s, valid)
    want = np.asarray(jak.flash_decode(jnp.asarray(q), k, v, jnp.asarray(mask)))
    got = ak.flash_decode_plain(_torch(q), _torch(k), _torch(v), _torch(mask))
    assert got.dtype == torch.float32 and np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # the wrapper takes the plain version for CPU tensors
    via = ak.flash_decode(_torch(q), _torch(k), _torch(v), _torch(mask))
    np.testing.assert_array_equal(via.numpy(), got.numpy())


def test_routing_takes_kernel_only_for_decode_on_the_card():
    cfg = tllama.ModelConfig.from_hf_config({**FLASH_HF, "num_attention_heads": 8, "num_key_value_heads": 2,
                                              "hidden_size": 1024})
    q = torch.zeros((3, 8, 1, 128))
    assert not ak.use_flash_decode(cfg, 1, q)  # CPU tensors: einsum path

    class Cuda:  # the attribute routing reads, on a pretend CUDA tensor
        is_cuda = True

    ak.reset_launch_counts()
    assert ak.use_flash_decode(cfg, 1, Cuda())  # a decode on the card
    assert not ak.use_flash_decode(cfg, 4, Cuda())  # prefill
    assert ak.launch_counts["decode_einsum"] == 0
    # the kernel takes D in {64, 128} and 1 <= G <= 64 (the JAX kernel's limit)
    for g in (1, 8, 16, 64):
        for d in (64, 128):
            assert ak.supported((2, 8, g, d), 4096)
    for g, d in ((4, 96), (4, 256), (65, 128), (65, 64)):
        assert not ak.supported((2, 8, g, d), 4096)
    # a model's geometry routes its decode: G = 16 (Llama-3.1-405B) to the
    # kernel, head_dim 96 or 256 and G = 65 to the counted einsum path
    g16 = tllama.ModelConfig.from_hf_config({**FLASH_HF, "num_attention_heads": 16, "hidden_size": 2048})
    assert ak.use_flash_decode(g16, 1, Cuda())
    for bad in ({"hidden_size": 192}, {"hidden_size": 512}, {"num_attention_heads": 65, "hidden_size": 65 * 64}):
        other = tllama.ModelConfig.from_hf_config({**FLASH_HF, **bad})  # D = 96; D = 256; G = 65
        assert not ak.use_flash_decode(other, 1, Cuda())
    assert ak.launch_counts["decode_einsum"] == 3 and ak.launch_counts["flash_decode"] == 0


@pytest.mark.parametrize("g", range(1, 65))
def test_head_chunks_cover_the_group_once(g):
    """The kernel's grid cuts a KV head's G query heads into ceil(G / 4)
    balanced chunks of at most 4, every chunk non-empty."""
    n, per = ak.head_chunks(g)
    assert n == -(-g // ak.CHUNK_GROUP) and per <= ak.CHUNK_GROUP == 4
    assert (n - 1) * per < g <= n * per


@pytest.mark.parametrize("sm", [1, 100, 256])
def test_short_mask_masks_the_rest_of_the_cache(sm):
    """A (B, Sm) mask, as forward builds it over attn_len slots, means the
    slots from Sm on are masked: the same as the full-length mask with a
    -1e9 tail."""
    q, k, v, mask = _inputs(sm, 2, 2, 4, 128, 256, "holes")
    short = np.full((2, sm), 0.0, np.float32)
    short[:, 1::3] = -1e9
    full = np.full((2, 256), -1e9, np.float32)
    full[:, :sm] = short
    got = ak.flash_decode(_torch(q), _torch(k), _torch(v), _torch(short))
    want = ak.flash_decode_plain(_torch(q), _torch(k), _torch(v), _torch(full))
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


@pytest.mark.parametrize("padded", [False, True])
def test_decode_logits_through_flash_route_match_jax(monkeypatch, padded):
    """Prefill then one T=1 decode step with the flash route forced on in
    both: the port (plain version, CPU) against the JAX forward with
    SHARDMERGE_FLASH_DECODE=1 (Pallas interpret mode). ``padded`` adds
    left pads masked through token_valid, as generate_batch sends them."""
    monkeypatch.setenv("SHARDMERGE_FLASH_DECODE", "1")
    calls = []

    def forced(cfg, t, q):
        calls.append(t)
        return t == 1

    monkeypatch.setattr(ak, "use_flash_decode", forced)
    jcfg = jllama.ModelConfig.from_hf_config(FLASH_HF)
    tcfg = tllama.ModelConfig.from_hf_config(FLASH_HF)
    params = jax.tree_util.tree_map(
        np.asarray, jllama.init_params(jcfg, jax.random.PRNGKey(7), dtype=jnp.float32)
    )
    model = tllama.LlamaModel(tcfg, params_from_jax(params))
    B, T, S = 2, 17, 128
    rng = np.random.default_rng(3)
    ids = rng.integers(0, 128, (B, T))
    pad = np.array([0, 5]) if padded else np.zeros(B, np.int64)
    slot = np.broadcast_to(np.arange(T - 1), (B, T - 1))
    pos = np.maximum(slot - pad[:, None], 0)
    valid = np.arange(S)[None, :] >= pad[:, None]
    kw_j = dict(mask_positions=jnp.asarray(slot), token_valid=jnp.asarray(valid)) if padded else {}
    kw_t = dict(mask_positions=torch.from_numpy(slot.copy()), token_valid=torch.from_numpy(valid)) if padded else {}

    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jrope = jllama.rope_tables(jcfg, S)
    jkv = jllama.init_kv_cache(jcfg, B, S, jnp.float32)
    _, jkv = jllama.forward(jp, jcfg, jnp.asarray(ids[:, :-1]), jnp.asarray(pos), jkv, 0, jrope, T - 1, **kw_j)
    step_pos = (T - 1 - pad)[:, None]
    kw_j1 = dict(mask_positions=jnp.full((B, 1), T - 1), token_valid=jnp.asarray(valid)) if padded else {}
    jl, _ = jllama.forward(jp, jcfg, jnp.asarray(ids[:, -1:]), jnp.asarray(step_pos), jkv, T - 1, jrope, T, **kw_j1)

    trope = tllama.rope_tables(tcfg, S)
    tkv = tllama.init_kv_cache(tcfg, B, S, torch.float32)
    kw_t1 = dict(mask_positions=torch.full((B, 1), T - 1), token_valid=torch.from_numpy(valid)) if padded else {}
    with torch.inference_mode():
        _, tkv = model(torch.from_numpy(ids[:, :-1]), torch.from_numpy(pos.copy()), tkv, 0, trope, T - 1, **kw_t)
        tl, _ = model(torch.from_numpy(ids[:, -1:]), torch.from_numpy(step_pos.copy()), tkv, T - 1, trope, T, **kw_t1)
    assert calls.count(1) == tcfg.num_hidden_layers  # the decode step took the route
    np.testing.assert_allclose(tl[:, -1].numpy(), np.asarray(jl[:, -1]), **TOL)


def test_compact_plain_lists_each_rows_valid_slots_in_order():
    rng = np.random.default_rng(4)
    ok = rng.random((4, 300)) > 0.4
    ok[2] = False  # a row with no valid slot
    ok[3, -1] = True
    mask = np.where(ok, 0.0, -1e9).astype(np.float32)
    mask[1, 5] = -3.0  # an additive penalty, not a masked slot
    idx, count = ak.compact_plain(torch.from_numpy(mask))
    assert idx.dtype == count.dtype == torch.int32 and idx.shape == (4, 300)
    for row in range(4):
        want = np.nonzero(mask[row] > -1e8)[0]
        assert int(count[row]) == want.size
        np.testing.assert_array_equal(idx[row, : want.size].numpy(), want)


@pytest.mark.parametrize(
    "b,kvh,g,s,valid",
    [
        (2, 2, 4, 768, "holes"),  # up to ~380 valid slots: two splits
        (1, 1, 8, 640, "holes"),
        (3, 2, 2, 640, "last7"),  # one split, the last 7 slots
        (1, 2, 16, 512, "holes"),  # Llama-3.1-405B's G = 16: two head chunks on the card
    ],
)
def test_split_order_model_matches_jax_kernel_and_plain(b, kvh, g, s, valid):
    """The kernel's order in plain torch (valid slots in blocks of SPLIT,
    merged in block order) against the JAX kernel in interpret mode and the
    plain version."""
    q, k, v, mask = _inputs(s + g, b, kvh, g, 128, s, valid)
    want = np.asarray(jak.flash_decode(jnp.asarray(q), k, v, jnp.asarray(mask)))
    got = ak.flash_decode_split_order(_torch(q), _torch(k), _torch(v), _torch(mask))
    assert got.dtype == torch.float32 and np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    plain = ak.flash_decode_plain(_torch(q), _torch(k), _torch(v), _torch(mask))
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **TOL)


@pytest.mark.parametrize("d", [64, 128])
def test_split_order_model_row_does_not_depend_on_other_rows_gaps_or_length(d):
    """A row's history of 300 valid slots (two splits) alone in a 512-slot
    cache, or in a batch of 3 over 1200 slots with gaps and a shorter
    mask, gives the same bits; a row with no valid slot gives zeros."""
    rng = np.random.default_rng(d)
    hist_k = rng.standard_normal((2, 300, d)).astype(np.float32)
    hist_v = rng.standard_normal((2, 300, d)).astype(np.float32)
    q = torch.from_numpy(rng.standard_normal((3, 2, 4, d)).astype(np.float32))
    k1 = torch.zeros((1, 2, 512, d), dtype=torch.bfloat16)
    v1 = torch.zeros((1, 2, 512, d), dtype=torch.bfloat16)
    k1[0, :, :300] = torch.from_numpy(hist_k).to(torch.bfloat16)
    v1[0, :, :300] = torch.from_numpy(hist_v).to(torch.bfloat16)
    m1 = torch.full((1, 512), -1e9)
    m1[0, :300] = 0.0
    k3 = torch.from_numpy(rng.standard_normal((3, 2, 1200, d)).astype(np.float32)).to(torch.bfloat16)
    v3 = torch.from_numpy(rng.standard_normal((3, 2, 1200, d)).astype(np.float32)).to(torch.bfloat16)
    spans = [(0, 120), (500, 600), (1000, 1080)]  # 300 slots around two join gaps
    m3 = torch.full((3, 1100), -1e9)
    at = 0
    for a, e in spans:
        k3[0, :, a:e] = k1[0, :, at : at + e - a]
        v3[0, :, a:e] = v1[0, :, at : at + e - a]
        m3[0, a:e] = 0.0
        at += e - a
    m3[1, :900] = 0.0  # row 2 has no valid slot
    alone = ak.flash_decode_split_order(q[:1], k1, v1, m1)
    pooled = ak.flash_decode_split_order(q, k3, v3, m3)
    assert torch.equal(pooled[0], alone[0])
    assert torch.equal(pooled[2], torch.zeros_like(pooled[2]))
    plain = ak.flash_decode_plain(q[:1], k1, v1, m1)
    np.testing.assert_allclose(alone.numpy(), plain.numpy(), **TOL)


def test_forward_hands_every_decode_layer_one_slot_list(monkeypatch):
    """A T=1 forward builds one Slots of its mask and hands it to every
    layer (so the card compacts once per step); prefill hands none. On the
    CPU the flash route computes the plain attention, so the logits equal
    the einsum path's."""
    seen = []

    def recording(q, k, v, mask, slots=None):
        seen.append((mask, slots))
        return ak.flash_decode_plain(q, k, v, mask)

    cfg = tllama.ModelConfig.from_hf_config(FLASH_HF)
    jcfg = jllama.ModelConfig.from_hf_config(FLASH_HF)
    params = jax.tree_util.tree_map(np.asarray, jllama.init_params(jcfg, jax.random.PRNGKey(3), dtype=jnp.float32))
    model = tllama.LlamaModel(cfg, params_from_jax(params))
    rope = tllama.rope_tables(cfg, 64)
    ids = torch.from_numpy(np.random.default_rng(1).integers(0, 128, (2, 9)))
    pos = torch.arange(8)[None].expand(2, 8)
    with torch.inference_mode():
        kv = tllama.init_kv_cache(cfg, 2, 64, torch.float32)
        _, kv = model(ids[:, :8], pos, kv, 0, rope, 8)
        kv_einsum = {n: t.clone() for n, t in kv.items()}
        want, _ = model(ids[:, 8:], torch.full((2, 1), 8), kv_einsum, 8, rope, 9)
        monkeypatch.setattr(ak, "use_flash_decode", lambda cfg, t, q: t == 1)
        monkeypatch.setattr(ak, "flash_decode", recording)
        got, _ = model(ids[:, 8:], torch.full((2, 1), 8), kv, 8, rope, 9)
    assert len(seen) == cfg.num_hidden_layers
    slots = {id(s) for _, s in seen}
    assert len(slots) == 1 and seen[0][1] is not None
    assert all(torch.equal(m, seen[0][1].mask) for m, _ in seen)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


class _StubTokenizer:
    """One token per character, decoded injectively."""

    chat_template = None
    eos_token_id = 1

    def encode(self, text):
        return [ord(c) % 96 + 2 for c in text]

    def decode(self, ids, skip_special_tokens=True):
        return "".join(f"<{i}>" for i in ids)


@pytest.mark.parametrize(
    "geometry,flash",
    [
        ({"num_attention_heads": 16, "num_key_value_heads": 1, "hidden_size": 1024}, True),  # G = 16, D = 64
        ({"num_attention_heads": 2, "num_key_value_heads": 1, "hidden_size": 192}, False),  # head_dim 96
    ],
)
def test_greedy_decode_of_other_geometries_matches_jax(monkeypatch, geometry, flash):
    """Greedy tokens of a G = 16 model and of a head_dim 96 model equal the
    JAX engine's on the same seeded weights (carried across by
    models/convert.py). The G = 16 model decodes through the flash route
    (its plain version on the CPU), as it does through the kernel on the
    card; the head_dim 96 model takes the einsum path, as on the card."""
    from shardmerge_tpu.inference import InferenceEngine as JaxEngine
    from shardmerge_tpu_torch.inference import InferenceEngine

    hf = {**FLASH_HF, **geometry, "vocab_size": 128, "intermediate_size": 128}
    jcfg = jllama.ModelConfig.from_hf_config(hf)
    tcfg = tllama.ModelConfig.from_hf_config(hf)
    params = jax.tree_util.tree_map(np.asarray, jllama.init_params(jcfg, jax.random.PRNGKey(11), dtype=jnp.float32))
    routed = []

    def route(cfg, t, q):
        routed.append(t)
        return flash and t == 1

    monkeypatch.setattr(ak, "use_flash_decode", route)
    jeng = JaxEngine(jcfg, jax.tree_util.tree_map(jnp.asarray, params), _StubTokenizer())
    teng = InferenceEngine(tcfg, tllama.LlamaModel(tcfg, params_from_jax(params)), _StubTokenizer())
    prompts = ["hello there", "a", "the quick brown fox"]
    kw = dict(max_new_tokens=5, greedy=True, return_meta=True)
    ours = teng.generate_batch(prompts, **kw)
    assert ours == jeng.generate_batch(prompts, use_template=False, **kw)
    assert all(t for t in ours[0]) and routed.count(1) >= tcfg.num_hidden_layers
