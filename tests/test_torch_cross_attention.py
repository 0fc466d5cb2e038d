"""The port's masked cross-attention (``ops/cuda/cross_attention.py``, plain
version on CPU tensors) against the JAX package's ``masked_cross_attention``,
its XLA branch and its Pallas kernel in interpret mode, on the same numpy
inputs."""

import contextlib
from pathlib import Path

import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from xmc_gan_tpu.ops.pallas.cross_attention import masked_cross_attention as jax_mca
from xmc_gan_tpu_torch.config import cfg_from_dict, cfg_from_file
from xmc_gan_tpu_torch.models import concept_gan as pcg
from xmc_gan_tpu_torch.ops import cross_attention as seam
from xmc_gan_tpu_torch.ops.cuda import build as cuda_build
from xmc_gan_tpu_torch.ops.cuda import cross_attention as ca
from xmc_gan_tpu_torch.train import make_generator

BF16_ULP = 2.0 ** -7
CONCEPT_CFG = Path(__file__).resolve().parents[1] / "xmc_gan_tpu/cfg/concept_in_df_gan.yml"


def _inputs(seed, b, n, t, d, lens=None):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(b, m, d).astype(np.float32) for m in (n, t, t))
    mask = np.zeros((b, t), bool)
    for i, n_words in enumerate(lens or [t // 2, 3]):
        mask[i, n_words:] = True
    return q, k, v, mask


def _port(q, k, v, mask, scale=1.0):
    return ca.masked_cross_attention_kernel(*map(torch.from_numpy, (q, k, v, mask)), scale).numpy()


# (n, t, d, scale): the JAX package's kernel tests (test_pallas_ops.py:38-57),
# the concept shape (D = 4, T = 15) and a ragged D = 48 one.
CASES = [(64, 20, 32, 0.7), (300, 260, 32, 0.7), (256, 15, 4, 1.0), (77, 33, 48, 0.7)]


@pytest.mark.parametrize("n,t,d,scale", CASES)
def test_plain_matches_jax_xla(n, t, d, scale):
    """Tolerance 1e-5: the same fp32 math in another summation order."""
    q, k, v, mask = _inputs(0, 2, n, t, d)
    want = np.asarray(jax_mca(q, k, v, mask, scale=scale, backend="xla"))
    np.testing.assert_allclose(_port(q, k, v, mask, scale), want, rtol=1e-5, atol=1e-5)


def test_plain_matches_pallas_interpret_and_pins_the_fully_padded_row():
    """T = 150 streams two of the Pallas kernel's 128-word blocks; row 2 has
    no word.  The port and the Pallas kernel give that row 0; the JAX XLA
    branch's dense softmax gives NaN there (the recorded difference between
    the two JAX backends; the port follows the kernel).  Tolerance 2e-5, as
    the JAX package's own kernel test."""
    q, k, v, mask = _inputs(1, 3, 40, 150, 8, lens=[150, 7, 0])
    got = _port(q, k, v, mask, 0.5)
    with pltpu.force_tpu_interpret_mode():
        pallas = np.asarray(jax_mca(q, k, v, mask, scale=0.5, backend="pallas"))
    xla = np.asarray(jax_mca(q, k, v, mask, scale=0.5, backend="xla"))
    np.testing.assert_allclose(got, pallas, rtol=2e-5, atol=2e-5)
    assert (got[2] == 0).all() and (pallas[2] == 0).all()
    assert np.isnan(xla[2]).all()
    np.testing.assert_allclose(got[:2], xla[:2], rtol=1e-5, atol=1e-5)


def test_grouped_operands_share_the_row_mask():
    """``q`` ``[B, G, N, D]`` and ``k``/``v`` ``[B, G, T, D]`` as strided views
    (the In sampler's layout, ``[B, N, G, D]`` in memory) with a ``[B, T]``
    mask: the same as the JAX function on ``[B*G, ...]`` rows with the mask
    repeated over G."""
    rng = np.random.RandomState(2)
    b, g, n, t, d = 2, 3, 10, 6, 4
    qm = rng.randn(b, n, g, d).astype(np.float32)
    km = rng.randn(b, t, g, d).astype(np.float32)
    mask = np.array([[False] * 4 + [True] * 2, [False] * 2 + [True] * 4])
    q4 = torch.from_numpy(qm).transpose(1, 2)
    k4 = torch.from_numpy(km).transpose(1, 2)
    assert not q4.is_contiguous()
    got = seam.masked_cross_attention(q4, k4, k4, torch.from_numpy(mask))
    assert got.shape == (b, g, n, d) and got.is_contiguous()
    flat = lambda x: np.ascontiguousarray(x.transpose(0, 2, 1, 3)).reshape(b * g, -1, d)
    want = jax_mca(flat(qm), flat(km), flat(km), np.repeat(mask, g, axis=0), backend="xla")
    np.testing.assert_allclose(got.numpy().reshape(b * g, n, d), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def test_padded_words_do_not_matter():
    """As ``test_pallas_ops.py:60-76``: changing padded keys and values
    leaves the output as it was."""
    q, k, v, mask = _inputs(3, 1, 16, 10, 8, lens=[6])
    a = _port(q, k, v, mask)
    k2, v2 = k.copy(), v.copy()
    k2[0, 6:] += 50
    v2[0, 6:] -= 50
    np.testing.assert_allclose(_port(q, k2, v2, mask), a, rtol=1e-6)


def test_bf16_rounds_once_on_store():
    """bf16 operands: fp32 math inside, so the bf16 output is the fp32 result
    on the same (bf16-valued) operands rounded once: within one bf16 ulp."""
    q, k, v, mask = (torch.from_numpy(x) for x in _inputs(4, 2, 33, 19, 12))
    qb, kb, vb = q.bfloat16(), k.bfloat16(), v.bfloat16()
    got = ca.masked_cross_attention_kernel(qb, kb, vb, mask, 0.5)
    assert got.dtype == torch.bfloat16
    want = ca.masked_cross_attention_ref(qb.float(), kb.float(), vb.float(), mask, 0.5)
    torch.testing.assert_close(got.float(), want, rtol=BF16_ULP, atol=0)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    q, k, v, mask = (torch.from_numpy(x) for x in _inputs(5, 2, 8, 5, 4))
    with pytest.raises(ValueError, match="share one D"):
        ca.masked_cross_attention_kernel(q, k, torch.zeros(2, 5, 6), mask)
    with pytest.raises(ValueError, match="mask"):
        ca.masked_cross_attention_kernel(q, k, v, mask[:, :3])
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ca.masked_cross_attention_kernel(q, k.bfloat16(), v, mask)
    with pytest.raises(ValueError, match="D <= 256"):
        big = torch.zeros(2, 5, 300)
        ca.masked_cross_attention_kernel(torch.zeros(2, 8, 300), big, big, mask)
    with pytest.raises(ValueError, match=r"\[B, \(G,\) N, D\]"):
        ca.masked_cross_attention_kernel(q[0], k, v, mask)


def test_cpu_tensors_take_the_plain_version_without_counting():
    """Autograd runs through the plain version on the CPU; the kernel's
    count stays put."""
    q, k, v, mask = (torch.from_numpy(x) for x in _inputs(6, 2, 8, 5, 4))
    before = ca.FORWARD.launches
    out = ca.masked_cross_attention_kernel(q.requires_grad_(), k, v, mask)
    assert out.requires_grad and ca.FORWARD.launches == before
    torch.testing.assert_close(out, ca.masked_cross_attention_ref(q, k, v, mask), rtol=0, atol=0)


def test_kernel_build_without_nvcc_raises_clearly(tmp_path, monkeypatch):
    """The CUDA path has no CPU mode: without the toolkit it raises."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.CudaLibrary("cross_attention.cu", ca.KERNEL.signatures).load()


# ----------------------------------------------------------------- the plan

IN_NS = (256, 1024, 1024, 4096, 4096, 16384, 16384, 65536, 65536, 65536)


def _rows(b, g, n, d):
    """q's strides as rows: [B, N, G, D] in memory (the channels_last query
    map) seen as [B, G, N, D]."""
    return (n * g * d, d, g * d, 1)


def _planes(b, g, n, d):
    """q's strides as planes: [B, G, D, N] in memory (the map after a CUDA
    GroupNorm, which returns NCHW) seen as [B, G, N, D]."""
    return (g * d * n, d * n, 1, n)


def _dense(g, n, d):
    """q's strides as a dense [B, G, N, D] (the Out sampler's [B, N, D]
    seen with G = 1)."""
    return (g * n * d, n * d, d, 1)


# (B, G, N, T, D, q's strides, q's address mod 16, the kernel, planes)
PLAN_CASES = [(128, 16, n, 15, 4, _rows(128, 16, n, 4), 0, ca.GROUPED, False) for n in IN_NS] + [
    (128, 16, n, 15, 4, _planes(128, 16, n, 4), 0, ca.GROUPED, True) for n in IN_NS] + [
    (2, 16, 77, 15, 4, _rows(2, 16, 77, 4), 0, ca.GROUPED, False),  # N no multiple of a tile
    (2, 16, 300, 32, 4, _rows(2, 16, 300, 4), 0, ca.GROUPED, False),     # T at the cap
    (2, 16, 300, 33, 4, _rows(2, 16, 300, 4), 0, ca.SMALL, False),       # past it
    (2, 16, 300, 0, 4, _rows(2, 16, 300, 4), 0, ca.SMALL, False),        # no words
    (3, 8, 100, 20, 4, _rows(3, 8, 100, 4), 0, ca.GROUPED, False),       # G != 16
    (3, 8, 96, 20, 4, _planes(3, 8, 96, 4), 0, ca.GROUPED, True),
    (2, 32, 130, 15, 4, _rows(2, 32, 130, 4), 0, ca.GROUPED, False),     # the widest G
    (2, 2, 1500, 5, 4, _rows(2, 2, 1500, 4), 0, ca.GROUPED, False),
    (2, 64, 50, 15, 4, _rows(2, 64, 50, 4), 0, ca.SMALL, False),         # too wide
    (2, 12, 50, 15, 4, _rows(2, 12, 50, 4), 0, ca.SMALL, False),         # no power of two
    (2, 16, 64, 15, 4, (16 * 64 * 4, 64 * 4, 4, 1), 0, ca.SMALL, False),  # dense [B, G, N, D]
    (2, 16, 77, 15, 4, _planes(2, 16, 77, 4), 0, ca.SMALL, False),       # planes off 16 bytes
    (2, 16, 64, 15, 4, (16 * 64 * 4, 1, 32, 16), 0, ca.SMALL, False),    # no layout it reads
    (2, 16, 64, 15, 4, _rows(2, 16, 64, 4), 8, ca.SMALL, False),         # q off 16 bytes
    (128, 1, 16, 15, 4, _dense(1, 16, 4), 0, ca.SHORT, False),            # the Out sampler's
    (88, 1, 16, 15, 4, _dense(1, 16, 4), 0, ca.SHORT, False),             # the 64² step's
    (88, 1, 16, 20, 4, _dense(1, 16, 4), 0, ca.SHORT, False),             # T = 20
    (88, 1, 32, 15, 4, _dense(1, 32, 4), 0, ca.SHORT, False),             # N at attn_short's cap
    (88, 1, 33, 15, 4, _dense(1, 33, 4), 0, ca.SMALL, False),             # past it
    (88, 1, 16, 32, 4, _dense(1, 16, 4), 0, ca.SHORT, False),             # T at its cap
    (88, 1, 16, 33, 4, _dense(1, 16, 4), 0, ca.SMALL, False),             # past it
    (88, 1, 16, 0, 4, _dense(1, 16, 4), 0, ca.SMALL, False),              # no words
    (88, 1, 16, 15, 5, _dense(1, 16, 5), 0, ca.SMALL, False),             # D past 4
    (88, 1, 1, 1, 1, _dense(1, 1, 1), 4, ca.SHORT, False),                # the least of all
    (2, 3, 16, 15, 4, _dense(3, 16, 4), 0, ca.SHORT, False),              # G = 3
    (2, 16, 16, 15, 4, _rows(2, 16, 16, 4), 0, ca.GROUPED, False),        # attn_grouped first
    (2048, 4, 17, 20, 3, _dense(4, 17, 3), 0, ca.SHORT, False),           # 8,192 rows
    (2, 1, 300, 260, 32, (300 * 32, 300 * 32, 32, 1), 0, ca.SMALL, False),  # the JAX tests'
    (2, 16, 64, 15, 8, _rows(2, 16, 64, 8), 0, ca.SMALL, False),         # rows of D = 8
    (3, 2, 77, 33, 48, _rows(3, 2, 77, 48), 0, ca.WIDE, False),
    (4, 1, 1024, 200, 256, (1024 * 256, 1024 * 256, 256, 1), 0, ca.WIDE, False),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("b,g,n,t,d,strides,addr,kernel,planes", PLAN_CASES, ids=str)
def test_plan_names_the_kernel_its_precondition_says(b, g, n, t, d, strides, addr, kernel,
                                                     planes, dtype):
    """The ten In launches of a 256² request at batch 128, as rows and as
    planes, take ``attn_grouped``; around its limits (T, G, N, the strides,
    q's address, D) each shape takes the kernel whose precondition holds,
    and the geometry covers every query once."""
    p = ca.plan(b, g, n, t, d, strides, dtype, 4096 + addr)
    assert (p.kernel, p.planes) == (kernel, planes)
    if kernel == ca.GROUPED:
        es = torch.empty((), dtype=dtype).element_size()
        assert p.tile * g * d * es >= 16384 and p.tile % 64 == 0 and p.threads == 256
        ntiles = -(-n // p.tile)
        splits = p.blocks // b
        assert p.blocks == b * splits and 1 <= p.tiles_per_block <= 16
        assert (splits - 1) * p.tiles_per_block < ntiles <= splits * p.tiles_per_block
    elif kernel == ca.SHORT:  # a warp a (b, g) row; its word slots and lanes a query
        assert p.threads == 32 * p.tile and p.tile == (1 if b * g <= 4096 else 4)
        assert p.blocks == -(-b * g // p.tile) and p.tiles_per_block == 1
        assert (p.tmax, p.split) == (16 if t <= 16 else 32, 2 if n <= 16 else 1)
        assert p.tmax >= t and n * p.split <= 32
    else:
        assert p.tiles_per_block == 1 and p.blocks == b * g * -(-n // p.tile)


@pytest.mark.parametrize("layout", [_rows, _planes], ids=["rows", "planes"])
def test_plan_at_the_in_shapes_is_as_designed(layout):
    """bf16 tiles of 128 queries (16 KB), fp32 of 64; up to 16 tiles a block."""
    for dtype, tile, blocks in ((torch.bfloat16, 128, [256, 1024, 1024, 1024, 1024, 1024, 1024,
                                                        4096, 4096, 4096]),
                                (torch.float32, 64, [512, 1024, 1024, 1024, 1024, 2048, 2048,
                                                     8192, 8192, 8192])):
        plans = [ca.plan(128, 16, n, 15, 4, layout(128, 16, n, 4), dtype) for n in IN_NS]
        planes = layout is _planes
        assert {(p.kernel, p.planes, p.tile, p.threads) for p in plans} == {
            (ca.GROUPED, planes, tile, 256)}
        assert [p.blocks for p in plans] == blocks
        name = "float" if dtype == torch.float32 else "__nv_bfloat16"
        assert ca.kernel_name(plans[0], dtype, 4) == f"attn_grouped<{name}, {int(planes)}>"


@pytest.mark.parametrize("b,g,n,d,match", [(2, 1, 8, 0, "D <= 256"), (2, 1, 8, 257, "D <= 256"),
                                            (2**16, 2**10, 2**20, 4, "grid limit")])
def test_plan_raises_where_no_kernel_takes_the_shape(b, g, n, d, match):
    with pytest.raises(ValueError, match=match):
        ca.plan(b, g, n, 5, d, (n * g * d, n * d, d, 1), torch.float32)


# ------------------------------------------------- the In sampler's launches


@pytest.mark.parametrize("nchw_norm", [False, True], ids=["cpu_norm", "cuda_norm"])
@pytest.mark.parametrize("normalize", [True, False], ids=["normalize", "plain"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_in_sampler_launches_take_attn_grouped(normalize, nchw_norm, dtype, monkeypatch):
    """A CPU ``InNetG`` (``concept_in_df_gan.yml``, 64², NCH=8, T = 15,
    batch 2) hands the seam operands that ``plan`` sends to ``attn_grouped``
    at every In launch, so a layout change in the model cannot move the path
    off the kernel unseen.  The queries come as rows, or, with GEN.NORMALIZE
    where ``F.group_norm`` returns NCHW as it does on CUDA ("cuda_norm",
    reproduced here), as planes; the keys lie [B, G, D, T] with
    GEN.NORMALIZE (a d-stride of T), which the kernel reads in place."""
    if nchw_norm:
        real_gn = torch.nn.functional.group_norm
        monkeypatch.setattr(torch.nn.functional, "group_norm",
                            lambda *a, **kw: real_gn(*a, **kw).contiguous())
    cfg = cfg_from_dict({"IMG": {"SIZE": 64}, "TRAIN": {"NCH": 8}, "TEXT": {"ENCODER_DIR": ""},
                         "GEN": {"ENCODER_NAME": "CONCEPT_INATTN_GEN", "NORMALIZE": normalize}},
                        base=cfg_from_file(str(CONCEPT_CFG)))
    g = make_generator(cfg, dtype, "cpu", seed=0)
    seen, real = [], pcg.masked_cross_attention

    def spy(q, k, v, mask, scale=1.0):
        seen.append((tuple(q.shape), ca.plan_for(q, k), k.stride(-1), v is k))
        return real(q, k, v, mask, scale)

    monkeypatch.setattr(pcg, "masked_cross_attention", spy)
    rng = np.random.RandomState(0)
    T, E = cfg.TEXT.MAX_LENGTH, cfg.TEXT.EMBEDDING_DIM
    args = (rng.randn(2, cfg.TRAIN.NOISE_DIM), rng.randn(2, E), rng.randn(2, T, E))
    mask = torch.from_numpy(np.arange(T)[None, :] >= np.array([4, 15])[:, None])
    with torch.no_grad():
        g(*(torch.from_numpy(a.astype(np.float32)).to(dtype) for a in args), mask)
    shapes = pcg.attention_shapes(cfg, 2, "in")
    assert [s[0] for s in seen] == [(b, gr, n, d) for b, gr, n, _, d in shapes]
    assert {(p.kernel, p.planes) for _, p, _, _ in seen} == {(ca.GROUPED, normalize and nchw_norm)}
    assert {(stride, same) for _, _, stride, same in seen} == {(T if normalize else 1, True)}


def test_launch_hands_the_entry_the_plan(monkeypatch):
    """What ``_launch`` passes the C entry, with the library and the stream
    faked: the In sampler's operands go as they are (queries as rows or
    planes, the keys' d-stride T) with the plan's kernel, layout and
    geometry; an ``attn_small`` call gets dense copies of operands whose
    last stride is not 1."""
    calls = []

    class Lib:
        @staticmethod
        def xmc_cross_attention(*args):
            calls.append(args)
            return 0

    class Stream:
        cuda_stream = 0

    monkeypatch.setattr(ca.KERNEL, "load", lambda: Lib)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: Stream)
    b, g, n, t, d = 2, 16, 200, 15, 4
    q = torch.randn(b, n, g, d).transpose(1, 2)
    k = torch.randn(b, g, d, t).transpose(2, 3)  # [B, G, D, T] in memory
    mask = torch.zeros(b, t, dtype=torch.bool)
    ca._launch(q, k, k, mask, 1.0)
    args = calls[-1]
    p = ca.plan_for(q, k)
    assert args[5:10] == (b, g, n, t, d)
    assert args[10:14] == q.stride() and args[14:18] == k.stride() == args[18:22]
    assert args[0] == q.data_ptr() and args[1] == args[2] == k.data_ptr()
    assert args[27:34] == (ca._KERNEL_CODE[ca.GROUPED], 0, p.threads, p.blocks, p.tile,
                           p.tiles_per_block, 0)
    qp = torch.randn(b, g, d, n).transpose(2, 3)  # planes: [B, G, D, N] in memory
    ca._launch(qp, k, k, mask, 1.0)
    args = calls[-1]
    assert args[10:14] == qp.stride() and args[0] == qp.data_ptr()
    assert args[27:29] == (ca._KERNEL_CODE[ca.GROUPED], 1)
    q1 = torch.randn(b, 3, n, d)  # G = 3: attn_small, the keys copied dense
    k1 = torch.randn(b, 3, d, t).transpose(2, 3)
    ca._launch(q1, k1, k1, mask, 1.0)
    args = calls[-1]
    assert args[27] == ca._KERNEL_CODE[ca.SMALL] and args[14:18] == (3 * t * d, t * d, d, 1)
    assert args[1] != k1.data_ptr() and args[2] != k1.data_ptr()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_plan_names_attn_short_at_the_out_shapes(dtype):
    """The Out sampler's launch at a 256² request and the 64² train step's
    (T = 15 and 20): ``attn_short``, a warp a row, one wave of one-warp
    blocks, by the name the profiler gives its template instance."""
    name = "float" if dtype == torch.float32 else "__nv_bfloat16"
    for b, t, tmax in ((128, 15, 16), (88, 15, 16), (88, 20, 32)):
        p = ca.plan(b, 1, 16, t, 4, _dense(1, 16, 4), dtype)
        assert p == ca.Plan(ca.SHORT, False, 32, b, 1, 1, tmax, 2)
        assert ca.kernel_name(p, dtype, 4) == f"attn_short<{name}, {tmax}, 2>"
    p = ca.plan(88, 1, 17, 15, 4, _dense(1, 17, 4), dtype)
    assert ca.kernel_name(p, dtype, 4) == f"attn_short<{name}, 16, 1>"


def test_plan_allocates_nothing_and_is_memoized(monkeypatch):
    """``plan`` reads the element size from the type, not from a tensor it
    allocates, and gives the one plan for one set of arguments, where q's
    address counts only by its 16-byte alignment."""
    def no_alloc(*args, **kwargs):
        raise AssertionError("plan allocated a tensor")

    monkeypatch.setattr(torch, "empty", no_alloc)
    strides = _rows(3, 16, 40, 4)
    for dtype in (torch.float32, torch.bfloat16):
        a = ca.plan(3, 16, 40, 15, 4, strides, dtype, 4096)
        assert ca.plan(3, 16, 40, 15, 4, list(strides), dtype, 4096 + 64) is a
        assert a.kernel == ca.GROUPED
        assert ca.plan(3, 16, 40, 15, 4, strides, dtype, 4096 + 8).kernel == ca.SMALL


def test_launch_hands_attn_short_its_code_and_geometry(monkeypatch):
    """What ``_launch`` passes the C entry at the Out sampler's operands
    (q ``[B, 16, 4]``, the keys passed as the values), with the library and
    the stream faked: kernel code 3, the plan's geometry, the keys' address
    for both k and v; keys whose last stride is not 1 are copied once and
    still passed as the values; G = 3 takes it too."""
    calls = []

    class Lib:
        @staticmethod
        def xmc_cross_attention(*args):
            calls.append(args)
            return 0

    class Stream:
        cuda_stream = 0

    monkeypatch.setattr(ca.KERNEL, "load", lambda: Lib)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: Stream)
    b, n, t, d = 88, 16, 15, 4
    q, k = torch.randn(b, n, d), torch.randn(b, t, d)
    mask = torch.zeros(b, t, dtype=torch.bool)
    before = ca.FORWARD.launches
    out = ca._launch(q, k, k, mask, 1.0)
    assert out.shape == q.shape and ca.FORWARD.launches == before + 1
    args = calls[-1]
    p = ca.plan_for(q, k)
    assert args[5:10] == (b, 1, n, t, d)
    assert args[0] == q.data_ptr() and args[1] == args[2] == k.data_ptr()
    assert args[27:34] == (ca._KERNEL_CODE[ca.SHORT], 0, 32, b, 1, 1, 0) == (
        3, 0, p.threads, p.blocks, p.tile, p.tiles_per_block, 0)
    kt = torch.randn(b, d, t).transpose(1, 2)  # a d-stride of T: copied once
    ca._launch(q, kt, kt, mask, 1.0)
    args = calls[-1]
    assert args[1] == args[2] != kt.data_ptr() and args[14:18] == args[18:22] == (
        t * d, t * d, d, 1)
    v = torch.randn(b, t, d)  # values apart from the keys
    ca._launch(q, k, v, mask, 1.0)
    assert calls[-1][1:3] == (k.data_ptr(), v.data_ptr())
    q3, k3 = torch.randn(2, 3, n, d), torch.randn(2, 3, t, d)
    ca._launch(q3, k3, k3, mask[:2], 1.0)
    assert calls[-1][5:10] == (2, 3, n, t, d) and calls[-1][27:34] == (3, 0, 32, 6, 1, 1, 0)
