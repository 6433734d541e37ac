"""Tests of the port that need a CUDA card (marker ``cuda``; each skips on a
host without one). This file imports neither JAX nor the JAX package, so on
a machine without JAX it runs with the JAX suite's conftest switched off:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

chip_smoke.py holds the kernels to their plain versions at the full
Llama-3.1-8B decode shapes; these tests cover the wrappers' contracts and the
routing.
"""

import numpy as np
import pytest
import torch

from shardmerge_tpu_torch.models import attn_kernels as ak
from shardmerge_tpu_torch.models import quant
from shardmerge_tpu_torch.models import quant_kernels as qk

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


def _weights(n, k, card, seed=0):
    rng = np.random.default_rng(seed)
    wq = quant.quantize(rng.standard_normal((n, k)).astype(np.float32), bits=4)
    return wq["q"].to(card), wq["scale"].to(card)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 4e-3)])
@pytest.mark.parametrize("rows", [1, 3, 9, 32, 64])
def test_kernel_matches_plain_version(card, dtype, tol, rows):
    """Ragged shapes: N not a multiple of the 32-row tile, K/2 not a
    multiple of the 256-byte (bf16 x) or 64-byte (f32 x, split in two by
    the plan) chunk, row counts across the kernel's variants."""
    q, s = _weights(1000, 1056, card)
    x = torch.randn((rows, 1056), device=card).to(dtype)
    got = qk.int4_matmul(x, q, s)
    want = qk.int4_matmul_plain(x, q, s)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (rows, 1000)
    rel = float((got.float() - want.float()).norm() / want.float().norm())
    assert rel <= tol, rel


def test_kernel_counts_launches_and_keeps_leading_dims(card):
    q, s = _weights(256, 512, card)
    qk.reset_launch_counts()
    x = torch.randn((2, 3, 512), device=card, dtype=torch.bfloat16)
    y = qk.int4_matmul(x, q, s)
    assert y.shape == (2, 3, 256)
    assert qk.launch_counts["int4_gemv"] == 1


def test_wrapper_raises_instead_of_falling_back(card):
    q, s = _weights(256, 512, card)
    with pytest.raises(ValueError):
        qk.int4_matmul(torch.randn((65, 512), device=card), q, s)  # > 64 rows
    with pytest.raises(TypeError):
        qk.int4_matmul(torch.randn((1, 512), device=card, dtype=torch.float16), q, s)
    with pytest.raises(ValueError):
        qk.int4_matmul(torch.randn((1, 512), device=card), q.cpu(), s)


def test_dequant_matmul_routes_decode_rows_to_the_kernel(card):
    """<= 64 rows on the card take the kernel; a prefill-sized product
    takes the plain split-half matmul; both agree with the plain GEMV."""
    q, s = _weights(512, 1024, card)
    wq = {"q": q, "scale": s}
    qk.reset_launch_counts()
    small = torch.randn((4, 1024), device=card)
    big = torch.randn((2, 80, 1024), device=card)
    y_small = quant.dequant_matmul(small, wq)
    assert qk.launch_counts["int4_gemv"] == 1
    y_big = quant.dequant_matmul(big, wq)
    assert qk.launch_counts["int4_gemv"] == 1
    for x, y in ((small, y_small), (big, y_big)):
        want = qk.int4_matmul_plain(x, q, s)
        assert float((y - want).norm() / want.norm()) <= 1e-5


def _attn_inputs(card, b, kvh, g, s, seed=0, d=128):
    gen = torch.Generator(device=card).manual_seed(seed)
    q = torch.randn((b, kvh, g, d), device=card, generator=gen) / d**0.5
    k = torch.randn((b, kvh, s, d), device=card, generator=gen).to(torch.bfloat16)
    v = torch.randn((b, kvh, s, d), device=card, generator=gen).to(torch.bfloat16)
    return q, k, v


@pytest.mark.parametrize(
    "b,kvh,g,s,valid,d",
    [
        (1, 8, 4, 256, "tail", 128),  # a generate step early in its bucket
        (3, 2, 1, 1000, "holes", 128),  # ragged S, one query head per KV head
        (2, 1, 8, 4096, "last7", 128),  # every split but the last fully masked
        (64, 8, 4, 512, "holes", 128),  # the pool's largest slot count
        (1, 8, 4, 13, "tail", 128),  # fewer slots than one split
        (4, 8, 4, 2048, "holes", 64),  # head_dim 64 (Llama-3.2-1B)
        (2, 4, 8, 1000, "last7", 64),  # TinyLlama's G = 8, ragged S
        (1, 8, 3, 13, "tail", 64),
        (4, 8, 16, 2048, "holes", 128),  # Llama-3.1-405B's G = 16: two head chunks
        (2, 2, 64, 1000, "last7", 128),  # G = 64, the JAX kernel's limit: eight chunks
        (3, 1, 12, 700, "tail", 64),  # G = 12: two chunks of 6
        (2, 1, 9, 300, "holes", 128),  # G = 9: chunks of 5 and 4
    ],
)
def test_flash_kernel_matches_plain_version(card, b, kvh, g, s, valid, d):
    q, k, v = _attn_inputs(card, b, kvh, g, s, d=d)
    rng = np.random.default_rng(s)
    ok = np.ones((b, s), bool)
    if valid == "tail":
        ok[:, s // 2 + 1 :] = False
    elif valid == "holes":
        ok = rng.random((b, s)) > 0.3
        ok[:, 0] = True
    else:
        ok[:] = False
        ok[:, -7:] = True
    mask = torch.where(torch.from_numpy(ok).to(card), 0.0, -1e9)
    got = ak.flash_decode(q, k, v, mask)
    want = ak.flash_decode_plain(q, k, v, mask)
    torch.cuda.synchronize()
    assert got.shape == (b, kvh, g, d) and bool(torch.isfinite(got).all())
    rel = float((got - want).norm() / want.norm())
    assert rel <= 1e-5, rel


@pytest.mark.parametrize("g", [4, 16, 64])
def test_flash_kernel_row_bits_do_not_depend_on_batch_length_or_gaps(card, g):
    """A row's output depends only on its valid K/V rows in order: the same
    history alone in a 256-slot cache, or in a batch of 8 over 4096 slots
    with a join gap and a short mask, gives the same bits; with G > 8 the
    heads run in chunks, and a head's bits do not depend on them."""
    q, k1, v1 = _attn_inputs(card, 1, 8, g, 256, seed=5)
    _, k8, v8 = _attn_inputs(card, 8, 8, g, 4096, seed=6)
    for src, dst in ((k1, k8), (v1, v8)):
        dst[0, :, :100] = src[0, :, :100]
        dst[0, :, 2000:2050] = src[0, :, 100:150]
    m1 = torch.full((1, 256), -1e9, device=card)
    m1[:, :150] = 0.0
    m8 = torch.full((8, 3000), -1e9, device=card)
    m8[0, :100] = 0.0
    m8[0, 2000:2050] = 0.0
    m8[1:, :2500] = 0.0
    q8 = torch.cat([q, torch.randn((7, 8, g, 128), device=card)])
    alone = ak.flash_decode(q, k1, v1, m1)
    pooled = ak.flash_decode(q8, k8, v8, m8)
    assert torch.equal(pooled[0], alone[0])
    if g > 4:  # head h of a G-head call equals the same head in a call of 4 heads
        for h0 in (0, g - 4):
            part = ak.flash_decode(q[:, :, h0 : h0 + 4].contiguous(), k1, v1, m1)
            assert torch.equal(part[0], alone[0, :, h0 : h0 + 4])


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("g", range(1, 9))
def test_flash_kernel_at_the_split_edges(card, g, d):
    """Rows with SPLIT - 1, SPLIT and SPLIT + 1 valid slots (one split, one
    full split, a second split of one slot), scattered over the cache, and
    a row with none (zeros)."""
    split = ak.SPLIT
    q, k, v = _attn_inputs(card, 4, 2, g, 3 * split, seed=g, d=d)
    rng = np.random.default_rng(g * d)
    ok = np.zeros((4, 3 * split), bool)
    for row, n in enumerate((split - 1, split, split + 1)):
        ok[row, np.sort(rng.choice(3 * split, n, replace=False))] = True
    mask = torch.where(torch.from_numpy(ok).to(card), 0.0, -1e9)
    got = ak.flash_decode(q, k, v, mask)
    want = ak.flash_decode_plain(q, k, v, mask)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    rel = float((got[:3] - want[:3]).norm() / want[:3].norm())
    assert rel <= 1e-5, rel
    assert torch.equal(got[3], torch.zeros_like(got[3]))


def test_flash_kernel_row_bits_with_the_step_slot_list(card):
    """The bits test above with the slot list compacted once and handed to
    the call, as the forward does: the same bits as the call that compacts
    itself, and as the row alone."""
    q, _, _ = _attn_inputs(card, 1, 8, 4, 1, seed=5)
    _, k8, v8 = _attn_inputs(card, 8, 8, 4, 4096, seed=6)
    spans = [(0, 100), (2000, 2250), (3000, 3010)]  # 360 valid slots: two splits
    k1, v1 = (torch.zeros((1, 8, 512, 128), dtype=torch.bfloat16, device=card) for _ in range(2))
    k1[0, :, :360] = torch.cat([k8[0, :, a:b] for a, b in spans], dim=1)
    v1[0, :, :360] = torch.cat([v8[0, :, a:b] for a, b in spans], dim=1)
    m1 = torch.full((1, 512), -1e9, device=card)
    m1[:, :360] = 0.0
    m8 = torch.full((8, 3500), -1e9, device=card)
    for a, b in spans:
        m8[0, a:b] = 0.0
    m8[1:, :3300] = 0.0
    q8 = torch.cat([q, torch.randn((7, 8, 4, 128), device=card)])
    alone = ak.flash_decode(q, k1, v1, m1, slots=ak.compact(m1))
    slots = ak.compact(m8)
    pooled = ak.flash_decode(q8, k8, v8, m8, slots=slots)
    assert torch.equal(pooled[0], alone[0])
    assert torch.equal(ak.flash_decode(q8, k8, v8, m8), pooled)
    assert int(slots.count[0]) == 360 and torch.equal(slots.count[1:].cpu(), torch.full((7,), 3300, dtype=torch.int32))


def test_flash_kernel_one_device_launch_per_call_after_the_step_compaction(card):
    """A call with the step's slot list is one device launch; a forward
    decode step compacts once for all its layers."""
    from shardmerge_tpu_torch.models import llama

    q, k, v = _attn_inputs(card, 2, 2, 4, 700)
    mask = torch.zeros((2, 700), device=card)
    mask[1, 300:] = -1e9
    ak.reset_launch_counts()
    slots = ak.compact(mask)
    outs = [ak.flash_decode(q, k, v, mask, slots=slots) for _ in range(3)]
    assert ak.launch_counts == {"flash_compact": 1, "flash_decode": 3}
    assert all(torch.equal(o, outs[0]) for o in outs)
    ak.flash_decode(q, k, v, mask)  # no slot list: it compacts itself
    assert ak.launch_counts == {"flash_compact": 2, "flash_decode": 4}
    with pytest.raises(ValueError, match="another mask"):
        ak.flash_decode(q, k, v, mask.clone(), slots=slots)

    cfg = llama.ModelConfig(vocab_size=64, hidden_size=512, intermediate_size=128, num_hidden_layers=3,
                            num_attention_heads=4, num_key_value_heads=1)
    gen = torch.Generator().manual_seed(1)

    def w(*shape):
        return (torch.randn(shape, generator=gen) * 0.05).to(card)

    layer = {"q_proj": w(512, 512), "k_proj": w(128, 512), "v_proj": w(128, 512), "o_proj": w(512, 512),
             "gate_proj": w(128, 512), "up_proj": w(128, 512), "down_proj": w(512, 128),
             "input_layernorm": torch.ones(512, device=card), "post_attention_layernorm": torch.ones(512, device=card)}
    model = llama.LlamaModel(cfg, {"embed_tokens": w(64, 512), "norm": torch.ones(512, device=card),
                                   "lm_head": w(64, 512), "layers": [layer] * 3})
    rope = llama.rope_tables(cfg, 64, card)
    kv = llama.init_kv_cache(cfg, 2, 64, torch.bfloat16, card)
    with torch.inference_mode():
        model(torch.ones((2, 5), dtype=torch.long, device=card), torch.arange(5, device=card)[None].expand(2, 5),
              kv, 0, rope, 5)
        ak.reset_launch_counts()
        model(torch.ones((2, 1), dtype=torch.long, device=card), torch.full((2, 1), 5, device=card), kv, 5, rope, 6)
    assert ak.launch_counts == {"flash_compact": 1, "flash_decode": 3}


@pytest.mark.parametrize("rows", [4, 8, 64])
def test_decode_ops_give_a_row_the_same_bits_at_any_batch(card, rows):
    """What pool-vs-solo exactness rests on besides the flash kernel: the
    RMSNorm, a bf16 vocab-sized matmul and the int4 GEMV give row 0 the same
    bits alone as in a batch."""
    from shardmerge_tpu_torch.models import llama

    gen = torch.Generator(device=card).manual_seed(7)
    x = torch.randn((rows, 1, 4096), device=card, generator=gen).to(torch.bfloat16)
    w = (torch.rand(4096, device=card, generator=gen) + 0.5).to(torch.bfloat16)
    assert torch.equal(llama.rms_norm(x, w, 1e-5)[0], llama.rms_norm(x[:1], w, 1e-5)[0])
    head = (torch.randn((32768, 4096), device=card, generator=gen) * 0.02).to(torch.bfloat16)
    assert torch.equal(llama.matmul(x[:, 0], head)[0], llama.matmul(x[:1, 0], head)[0])
    q, s = _weights(4096, 4096, card)
    assert torch.equal(qk.int4_matmul(x[:, 0], q, s)[0], qk.int4_matmul(x[:1, 0], q, s)[0])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n,k", [(14336, 4096), (1024, 4096), (4096, 14336)])
def test_int4_kernel_row_bits_at_any_batch(card, n, k, dtype):
    """Row 0 of the GEMV has the same bits at B = 1, 8, 32 and 64 at the
    Llama-3.1-8B shapes (one split, or two; eight for f32 x at N = 1024):
    the plan and the K order never depend on B."""
    q, s = _weights(n, k, card, seed=n + k)
    gen = torch.Generator(device=card).manual_seed(n)
    x = torch.randn((64, k), device=card, generator=gen).to(dtype)
    alone = qk.int4_matmul(x[:1], q, s)
    for rows in (8, 32, 64):
        assert torch.equal(qk.int4_matmul(x[:rows], q, s)[0], alone[0]), rows


def test_int4_kernel_copies_a_misaligned_x(card):
    """x at an offset that is not 16-byte aligned (a view into a larger
    buffer) is copied, not misread."""
    q, s = _weights(512, 1024, card)
    buf = torch.randn(4 * 1024 + 3, device=card).to(torch.bfloat16)
    x = buf[3:].view(4, 1024)
    assert x.data_ptr() % 16
    got = qk.int4_matmul(x, q, s)
    want = qk.int4_matmul_plain(x, q, s)
    assert float((got.float() - want.float()).norm() / want.float().norm()) <= 4e-3


def test_flash_kernel_counts_launches_and_raises_instead_of_falling_back(card):
    q, k, v = _attn_inputs(card, 2, 2, 4, 256)
    mask = torch.zeros((2, 256), device=card)
    ak.reset_launch_counts()
    ak.flash_decode(q, k, v, mask)
    assert ak.launch_counts["flash_decode"] == 1
    with pytest.raises(TypeError):
        ak.flash_decode(q.to(torch.bfloat16), k, v, mask)
    with pytest.raises(ValueError):
        ak.flash_decode(q, k.float(), v, mask)
    with pytest.raises(ValueError):
        ak.flash_decode(q, k.transpose(2, 3).contiguous().transpose(2, 3), v, mask)
    with pytest.raises(ValueError):
        ak.flash_decode(q[..., :96].contiguous(), k[..., :96].contiguous(), v[..., :96].contiguous(), mask)
    with pytest.raises(ValueError):  # G = 65: more query heads per KV head than the kernel takes
        ak.flash_decode(torch.zeros((2, 1, 65, 128), device=card), k[:, :1].contiguous(), v[:, :1].contiguous(), mask)
    assert ak.launch_counts["flash_decode"] == 1


def test_decode_attention_routes_to_the_flash_kernel(card):
    """A T=1 forward on the card launches the kernel once per layer; a
    prefill launches it not at all; the logits agree with the same step on
    the plain version. f32 weights over the bf16 cache, so the attention
    output reaches o_proj unrounded and the logits measure the kernel, not
    which bf16 roundings its last-bit differences flip."""
    from unittest import mock

    from shardmerge_tpu_torch.models import llama

    cfg = llama.ModelConfig(
        vocab_size=256, hidden_size=512, intermediate_size=512, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=1,
    )
    gen = torch.Generator().manual_seed(3)

    def w(*shape):
        return (torch.randn(shape, generator=gen) * 0.05).to(card)

    layers = [
        {
            "q_proj": w(512, 512), "k_proj": w(128, 512), "v_proj": w(128, 512),
            "o_proj": w(512, 512), "gate_proj": w(512, 512), "up_proj": w(512, 512),
            "down_proj": w(512, 512), "input_layernorm": torch.ones(512, device=card),
            "post_attention_layernorm": torch.ones(512, device=card),
        }
        for _ in range(2)
    ]
    params = {"embed_tokens": w(256, 512), "norm": torch.ones(512, device=card),
              "lm_head": w(256, 512), "layers": layers}
    model = llama.LlamaModel(cfg, params)
    rope = llama.rope_tables(cfg, 256, card)
    kv = llama.init_kv_cache(cfg, 2, 256, torch.bfloat16, card)
    ids = torch.randint(0, 256, (2, 9), generator=gen).to(card)
    pos = torch.arange(9, device=card)[None].expand(2, 9)
    ak.reset_launch_counts()
    with torch.inference_mode():
        logits, kv = model(ids, pos, kv, 0, rope, 9)
        assert ak.launch_counts["flash_decode"] == 0
        tok = logits[:, -1].argmax(-1)[:, None]
        step = torch.full((2, 1), 9, device=card)
        kv_plain = {n: t.clone() for n, t in kv.items()}
        got, _ = model(tok, step, kv, 9, rope, 10)
        assert ak.launch_counts["flash_decode"] == 2
        with mock.patch.object(ak, "flash_decode", lambda q, k, v, m, slots=None: ak.flash_decode_plain(q, k, v, m)):
            want, _ = model(tok, step, kv_plain, 9, rope, 10)
    assert float((got - want).norm() / want.norm()) <= 2e-3


def _tiny_model(cfg, device, seed):
    """A 2-layer model of ``cfg`` with f32 weights from a seeded generator."""
    from shardmerge_tpu_torch.models import llama

    gen = torch.Generator().manual_seed(seed)
    h, kv, i = cfg.hidden_size, cfg.num_key_value_heads * cfg.head_dim, cfg.intermediate_size
    q_out = cfg.num_attention_heads * cfg.head_dim

    def w(*shape):
        return (torch.randn(shape, generator=gen) * 0.05).to(device)

    layers = [
        {"q_proj": w(q_out, h), "k_proj": w(kv, h), "v_proj": w(kv, h), "o_proj": w(h, q_out),
         "gate_proj": w(i, h), "up_proj": w(i, h), "down_proj": w(h, i),
         "input_layernorm": torch.ones(h, device=device), "post_attention_layernorm": torch.ones(h, device=device)}
        for _ in range(cfg.num_hidden_layers)
    ]
    return llama.LlamaModel(cfg, {"embed_tokens": w(cfg.vocab_size, h), "norm": torch.ones(h, device=device),
                                  "lm_head": w(cfg.vocab_size, h), "layers": layers})


@pytest.mark.parametrize(
    "heads,kv_heads,hidden,route",
    [
        (16, 1, 2048, "flash_decode"),  # G = 16, D = 128 (Llama-3.1-405B's group size)
        (2, 1, 192, "decode_einsum"),  # D = 96: the kernel does not take it
    ],
)
def test_every_llama_geometry_decodes_on_the_card(card, heads, kv_heads, hidden, route):
    """A model of any Llama geometry builds and decodes on the card: G = 16
    runs the flash kernel, head_dim 96 the einsum path (counted under
    ``decode_einsum``). Its decode logits agree with the same step on the
    plain attention (f32 weights, so the logits measure the attention)."""
    from unittest import mock

    from shardmerge_tpu_torch.models import llama

    cfg = llama.ModelConfig(vocab_size=256, hidden_size=hidden, intermediate_size=256, num_hidden_layers=2,
                            num_attention_heads=heads, num_key_value_heads=kv_heads)
    model = _tiny_model(cfg, card, seed=heads)
    rope = llama.rope_tables(cfg, 256, card)
    kv = llama.init_kv_cache(cfg, 2, 256, torch.bfloat16, card)
    ids = torch.randint(0, 256, (2, 9), generator=torch.Generator().manual_seed(1)).to(card)
    pos = torch.arange(9, device=card)[None].expand(2, 9)
    with torch.inference_mode():
        logits, kv = model(ids, pos, kv, 0, rope, 9)
        tok = logits[:, -1].argmax(-1)[:, None]
        step = torch.full((2, 1), 9, device=card)
        kv_plain = {n: t.clone() for n, t in kv.items()}
        ak.reset_launch_counts()
        got, _ = model(tok, step, kv, 9, rope, 10)
        counts = dict(ak.launch_counts)
        with mock.patch.object(ak, "use_flash_decode", lambda *a: False):
            want, _ = model(tok, step, kv_plain, 9, rope, 10)
    assert counts.get(route) == cfg.num_hidden_layers, counts
    assert counts.get("flash_decode", 0) == (cfg.num_hidden_layers if route == "flash_decode" else 0)
    assert bool(torch.isfinite(got).all())
    assert float((got - want).norm() / want.norm()) <= 2e-3


@pytest.fixture
def f32_card(card):
    """The plain DFTs' matmuls in full f32, as chip_smoke.py runs them."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield card
    torch.backends.cuda.matmul.allow_tf32 = prev


def _rel(got, want):
    return float((got - want).abs().norm() / want.abs().norm())


def _fft_planes(card, shape, seed):
    gen = torch.Generator(device=card).manual_seed(seed)
    return (torch.randn(shape, device=card, generator=gen), torch.randn(shape, device=card, generator=gen))


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("axis", ["rows", "cols"])
@pytest.mark.parametrize(
    "shape",
    [
        (64, 96),
        (32, 128),
        (64, 97),  # prime N: rows split (1, 97)
        (97, 40),  # prime M: cols split (1, 97)
        (24, 48),  # splits (6, 8) and (4, 6): ragged 64-wide tiles
        (4096, 8192),  # the Llama-3.1-8B bench shape: splits (64, 128) and (64, 64)
        (4096, 14336),  # rows: radix 7, one 14336-value line per block
        (4096, 4096),
        (14336, 4096),  # columns: two passes, split (112, 128), radix 7
        (8, 32768),  # rows: a line no block holds, two passes, split (128, 256)
        (128256, 64),  # columns: two passes, split (334, 384), a radix-167 stage
    ],
)
def test_dft_kernels_match_plain_version(f32_card, axis, shape, inverse):
    from shardmerge_tpu_torch.ops import pallas_fft as pf

    xr, xi = _fft_planes(f32_card, shape, sum(shape))
    kernel, plain = (pf.dft_rows, pf.dft_rows_plain) if axis == "rows" else (pf.dft_cols, pf.dft_cols_plain)
    got = kernel(xr, xi, inverse=inverse)
    want = plain(xr, xi, inverse=inverse)
    torch.cuda.synchronize()
    dim = 1 if axis == "rows" else 0
    z = torch.complex(xr.double(), xi.double())
    truth = torch.fft.ifft(z, dim=dim) if inverse else torch.fft.fft(z, dim=dim)
    got_c = torch.complex(got[0].double(), got[1].double())
    assert got[0].shape == shape and bool(torch.isfinite(got_c).all())
    assert _rel(got_c, torch.complex(want[0].double(), want[1].double())) <= 1e-5
    assert _rel(got_c, truth) <= 1e-5


@pytest.mark.parametrize("inverse", [False, True])
def test_dft_rows_direct_route_matches_truth(card, inverse):
    """N = 2 * 16411: the prime pass is longer than a block holds and runs
    the direct sum (the plain version's 16411 x 16411 tables are not built
    here: the complex128 truth is the yardstick)."""
    from shardmerge_tpu_torch.ops import pallas_fft as pf

    shape = (3, 2 * 16411)
    assert [p.threads for p in pf._plan("dft_rows", *shape)] == [0, 512]
    xr, xi = _fft_planes(card, shape, 5)
    got = pf.dft_rows(xr, xi, inverse=inverse)
    torch.cuda.synchronize()
    z = torch.complex(xr.double(), xi.double())
    truth = torch.fft.ifft(z, dim=1) if inverse else torch.fft.fft(z, dim=1)
    got_c = torch.complex(got[0].double(), got[1].double())
    assert bool(torch.isfinite(got_c).all())
    assert _rel(got_c, truth) <= 1e-5


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize(
    "B,N",
    [
        (8, 8),  # no radix stage, only the DFT-8
        (16, 64),
        (40, 1024),  # several lines per block, a ragged last block
        (256, 448),  # radix 7
        (256, 960),  # radices 3 and 5
        (256, 3584),  # radix 7 at full depth
        (4128, 4096),  # the padded columns pass of rfft2 at (4096, 8192)
        # every 2^k instance and the 7 / 3·5 lengths at B = 40: a ragged last
        # block wherever a block holds more than 8 lines
        *[(40, n) for n in (8, 16, 32, 64, 128, 256, 512, 2048, 4096, 448, 960, 3584, 120)],
    ],
)
def test_stockham_kernel_matches_plain_version(card, B, N, inverse):
    from shardmerge_tpu_torch.ops import fft_vpu as fv

    zr, zi = _fft_planes(card, (B, N), N)
    got = fv.fft_batched(zr, zi, inverse)
    want = fv.fft_batched_plain(zr, zi, inverse)
    torch.cuda.synchronize()
    z = torch.complex(zr.double(), zi.double())
    truth = torch.fft.ifft(z, dim=1) if inverse else torch.fft.fft(z, dim=1)
    got_c = torch.complex(got[0].double(), got[1].double())
    assert bool(torch.isfinite(got_c).all())
    assert _rel(got_c, torch.complex(want[0].double(), want[1].double())) <= 1e-5
    assert _rel(got_c, truth) <= 1e-5


@pytest.mark.parametrize("shape", [(64, 128), (128, 448), (4096, 8192)])
def test_rfft2_round_trip_on_the_card(f32_card, shape):
    from shardmerge_tpu_torch.ops import fft_vpu as fv
    from shardmerge_tpu_torch.ops import pallas_fft as pf

    x = _fft_planes(f32_card, shape, 11)[0]
    fv.reset_launch_counts()
    pf.reset_launch_counts()
    spec = fv.rfft2_vpu(x)
    assert _rel(spec.to(torch.complex128), torch.fft.rfftn(x.double())) <= 1e-5
    back = fv.irfft2_vpu(spec, shape)
    assert fv.launch_counts["fft_batched"] == 4
    assert _rel(back, x) <= 1e-5
    fr, fi = pf.fft2_mxu(x)
    assert _rel(pf.ifft2_mxu(fr, fi)[0], x) <= 1e-5
    assert pf.launch_counts["dft_rows"] == 2 and pf.launch_counts["dft_cols"] == 2


def test_fft_wrappers_raise_instead_of_falling_back(card):
    from shardmerge_tpu_torch.ops import fft_vpu as fv
    from shardmerge_tpu_torch.ops import pallas_fft as pf

    xr, xi = _fft_planes(card, (32, 64), 1)
    pf.reset_launch_counts()
    fv.reset_launch_counts()
    with pytest.raises(TypeError):
        pf.dft_rows(xr.double(), xi.double())
    with pytest.raises(ValueError):
        pf.dft_cols(xr, xi[:16])
    with pytest.raises(TypeError):
        fv.fft_batched(xr.double(), xi.double(), False)
    with pytest.raises(ValueError):
        fv.fft_batched(xr[:12], xi[:12], False)  # B % 8 != 0, the JAX gate
    assert sum(pf.launch_counts.values()) == 0 and sum(fv.launch_counts.values()) == 0
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match="allow_tf32"):
            pf.dft_rows_plain(xr, xi)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def test_int4_matmul_backward_on_the_card(card):
    """Training through a frozen int4 base: an x that requires grad goes
    through Int4Matmul, whose forward launches the kernel once and whose
    backward is g @ dequant(W) in g's dtype (no launch); q and scale get no
    gradient."""
    q, s = _weights(1024, 512, card)
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn((3, 7, 512), device=card).to(dtype).requires_grad_(True)
        g = torch.randn((3, 7, 1024), device=card).to(dtype)
        qk.reset_launch_counts()
        y = quant.dequant_matmul(x, {"q": q, "scale": s})
        assert type(y.grad_fn).__name__ == "Int4MatmulBackward" and qk.launch_counts["int4_gemv"] == 1
        (dx,) = torch.autograd.grad(y, x, g)
        assert qk.launch_counts["int4_gemv"] == 1
        want = g @ quant.dequant({"q": q, "scale": s}, dtype)
        assert dx.dtype == dtype and torch.equal(dx, want)
