"""The port's sampler export (``xmc_gan_tpu_torch/utils/export.py``, on
``torch.export``) against the JAX package's (``xmc_gan_tpu/utils/export.py``,
on ``jax.export``), at the sizes of ``tests/test_export.py`` (NCH 8, NEF 32,
NOISE_DIM 16, 64², EMBEDDING_DIM 48, MAX_LENGTH 8).

Both packages export with a symbolic batch, save, load, and serve the same
seeded numpy parameters (the JAX tree, and the port's ``state_dict`` made
from it by ``utils/convert``) and the same numpy inputs at batch 3, 5 and 1.
Tolerance: 5e-5 absolute on the ``tanh`` output in fp32, as the port's
generator tests hold against the JAX modules (XLA's and PyTorch's CPU
convolutions sum in another order).  The port's exported program against its
own eager sampler is bit-equal (the same operators run).  The program holds
the hand kernels as registered operators, one node per kernel call of the
eager generator."""

import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import perturb as df_perturb
from torch_port_helpers import small_cfgs
from xmc_gan_tpu.models import concept_gan as jcg
from xmc_gan_tpu.models.df_gan import NetG as JaxNetG
from xmc_gan_tpu.utils import export as jexport
from xmc_gan_tpu_torch.ops.cuda import cross_attention as ca
from xmc_gan_tpu_torch.ops.cuda import fused_affine as fa
from xmc_gan_tpu_torch.train import make_generator, make_sample_fn
from xmc_gan_tpu_torch.utils import export as pexport
from xmc_gan_tpu_torch.utils.convert import (
    concept_generator_state_dict,
    df_gan_generator_state_dict,
)

REPO = Path(__file__).resolve().parents[1]
NOISE, EMB, T = 16, 48, 8
WORD_FAMILIES = ("CONCEPT_OUTATTN_GEN", "CONCEPT_INATTN_GEN")
FAMILIES = ("DF_GEN",) + WORD_FAMILIES
ATOL = 5e-5


def overrides(gen: str) -> dict:
    return {"TRAIN": {"NCH": 8, "NEF": 32, "NOISE_DIM": NOISE, "HE_INIT": True},
            "GEN": {"ENCODER_NAME": gen}, "IMG": {"SIZE": 64},
            "TEXT": {"EMBEDDING_DIM": EMB, "MAX_LENGTH": T}}


def inputs(b: int, seed: int = 0):
    """Seeded numpy noise, sentence and word embeddings, and a mask with
    1..T real words a caption (True = padding)."""
    rng = np.random.RandomState(seed + b)
    noise = rng.randn(b, NOISE).astype(np.float32)
    sent = rng.randn(b, EMB).astype(np.float32)
    words = rng.randn(b, T, EMB).astype(np.float32)
    mask = np.arange(T)[None] >= rng.randint(1, T + 1, (b, 1))
    return noise, sent, words, mask


def concept_perturb(tree, seed: int):
    """Every leaf drawn anew (as ``tests/test_torch_concept.py`` draws them):
    kernels ~ N(0, 1/fan_in), norm scales ~ 1 +- 0.1, other leaves ~ N(0,
    0.1^2), gates ~ U(0.5, 1.5)."""
    rng = np.random.RandomState(seed)

    def leaf(name, shape):
        if name == "gamma":
            return rng.uniform(0.5, 1.5, shape)
        if name == "kernel":
            fan_in = shape[1] if len(shape) == 3 else np.prod(shape[:-1])
            return rng.standard_normal(shape) / np.sqrt(fan_in)
        if name.endswith("scale"):
            return 1.0 + 0.1 * rng.standard_normal(shape)
        return 0.1 * rng.standard_normal(shape)

    def walk(node):
        return {k: walk(v) if isinstance(v, dict) else leaf(k, np.shape(v)).astype(np.float32)
                for k, v in node.items()}

    return walk(tree)


def jax_params(gen: str, jcfg):
    """Perturbed JAX generator params and the port's state_dict of them."""
    noise, sent, words, mask = (jnp.asarray(a) for a in inputs(2))
    if gen == "DF_GEN":
        shapes = jax.eval_shape(JaxNetG(jcfg).init, jax.random.PRNGKey(0), noise, sent)
        params = df_perturb(shapes["params"], 1)
        return params, df_gan_generator_state_dict(params)
    module = {"CONCEPT_OUTATTN_GEN": jcg.OutNetG, "CONCEPT_INATTN_GEN": jcg.InNetG}[gen](jcfg)
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), noise, sent, words, mask)
    params = concept_perturb(shapes["params"], 2)
    return params, concept_generator_state_dict(params)


_CACHE: dict = {}


def exported(gen: str, tmp_path_factory):
    """(JAX server, port server, JAX params, port state_dict, port
    ExportedProgram, params template) of ``gen``, each export saved and
    loaded once a module."""
    if gen not in _CACHE:
        jcfg, cfg = small_cfgs(overrides(gen))
        root = tmp_path_factory.mktemp(gen.lower())
        jex, _ = jexport.export_sampler(jcfg, platforms=("cpu",))
        jserve = jexport.load_sampler(jexport.save_sampler(str(root / "s.jaxexport"), jex))
        pex, template = pexport.export_sampler(cfg, device="cpu")
        pserve = pexport.load_sampler(pexport.save_sampler(str(root / "s.pt2"), pex))
        params, sd = jax_params(gen, jcfg)
        _CACHE[gen] = jserve, pserve, params, sd, pex, template
    return _CACHE[gen]


@pytest.mark.parametrize("b", [3, 5, 1])
@pytest.mark.parametrize("gen", FAMILIES)
def test_exported_sampler_matches_jax(gen, b, tmp_path_factory):
    """One symbolic-batch artifact of each package serves batches 3, 5 and
    1 with the same images, within ``ATOL`` (fp32); the port's artifact is
    bit-equal to its eager ``make_sample_fn`` on the same weights."""
    jserve, pserve, params, sd, _, _ = exported(gen, tmp_path_factory)
    noise, sent, words, mask = inputs(b)
    word_args = (words, mask) if gen in WORD_FAMILIES else ()
    want = np.asarray(jserve(params, noise, sent, *word_args))
    got = pserve(sd, noise, sent, *word_args)
    assert got.shape == want.shape == (b, 64, 64, 3) and got.dtype == torch.float32
    assert np.mean(np.abs(want) > 0.99) < 0.5  # not saturated: the test has teeth
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    _, cfg = small_cfgs(overrides(gen))
    g = make_generator(cfg, device="cpu")
    g.load_state_dict(sd, strict=True)
    eager = make_sample_fn(cfg, g)(*map(torch.from_numpy, (noise, sent, *word_args)))
    assert torch.equal(got, eager), (got - eager).abs().max()


@pytest.mark.parametrize("gen", FAMILIES)
def test_params_template_is_the_generator_state_dict(gen, tmp_path_factory):
    *_, template = exported(gen, tmp_path_factory)
    _, cfg = small_cfgs(overrides(gen))
    sd = make_generator(cfg, device="cpu").state_dict()
    assert list(template) == list(sd)
    assert all(template[k].shape == v.shape and template[k].dtype == v.dtype
               and template[k].device.type == "meta" for k, v in sd.items())


def _eager_kernel_calls(gen: str, monkeypatch) -> dict:
    """How many times each kernel's plain version runs in one eager CPU
    forward of the generator (one run a kernel call)."""
    calls = {"fused_affine": 0, "masked_cross_attention": 0}

    def counting(name, fn):
        def wrapped(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)
        return wrapped

    _, cfg = small_cfgs(overrides(gen))
    sample = make_sample_fn(cfg, device="cpu")
    noise, sent, words, mask = map(torch.from_numpy, inputs(2))
    with monkeypatch.context() as m:
        m.setattr(fa, "_ref", counting("fused_affine", fa._ref))
        m.setattr(ca, "masked_cross_attention_ref",
                  counting("masked_cross_attention", ca.masked_cross_attention_ref))
        sample(noise, sent, words, mask)
    return calls


@pytest.mark.parametrize("gen,op,vectors,n", [
    ("DF_GEN", "fused_affine", 4, 10), ("CONCEPT_OUTATTN_GEN", "masked_cross_attention", None, 6),
    ("CONCEPT_INATTN_GEN", "masked_cross_attention", None, 6),
    ("CONCEPT_IN_DF_GEN", "fused_affine", 2, 20), ("CONCEPT_OUT_DF_GEN", "fused_affine", 2, 20)])
def test_graph_holds_one_operator_node_per_kernel_call(gen, op, vectors, n, tmp_path_factory,
                                                       monkeypatch):
    """The exported graph calls the registered operator once for each call
    the eager generator makes of the kernel (``fused_affine``: the double
    form's 4 vectors in DF_GEN, the single form's 2 in the concept-DF
    families), and no other of the port's operators; tracing never runs the
    plain version (it raises while the export traces), so the graph holds
    the operator, not its decomposition."""
    if gen in FAMILIES:
        ep = exported(gen, tmp_path_factory)[4]
    else:
        _, cfg = small_cfgs(overrides(gen))
        with monkeypatch.context() as m:
            m.setattr(fa, "_ref", lambda *a: pytest.fail("the export traced the plain version"))
            ep, _ = pexport.export_sampler(cfg, device="cpu")
    nodes = [node for node in ep.graph.nodes
             if node.op == "call_function" and node.target in pexport.sampler_ops()]
    assert [node.target for node in nodes] == [getattr(torch.ops.xmc_gan_tpu_torch, op).default] * n
    if vectors:
        assert all(len(node.args[1]) == vectors for node in nodes)
    kernel = "masked_cross_attention" if op == "masked_cross_attention" else "fused_affine"
    assert _eager_kernel_calls(gen, monkeypatch)[kernel] == n


def test_pinned_batch_and_tracing_without_the_plain_version(tmp_path, monkeypatch):
    """``batch_size=3`` pins the batch: the artifact serves 3 rows, bit-equal
    to the eager sampler and to the program before it was saved, and
    refuses 5.  The plain version raises while the
    export traces: the trace never runs it."""
    _, cfg = small_cfgs(overrides("DF_GEN"))
    with monkeypatch.context() as m:
        m.setattr(fa, "_ref", lambda *a: pytest.fail("the export traced the plain version"))
        ep, template = pexport.export_sampler(cfg, batch_size=3, device="cpu")
    serve = pexport.load_sampler(pexport.save_sampler(str(tmp_path / "s.pt2"), ep))
    g = make_generator(cfg, device="cpu", seed=5)
    noise, sent, _, _ = inputs(3)
    got = serve(g.state_dict(), noise, sent)
    assert torch.equal(got, make_sample_fn(cfg, g)(noise, sent))
    assert torch.equal(pexport.sampler_fn(ep)(g.state_dict(), noise, sent), got)  # unsaved
    with pytest.raises(Exception):
        serve(g.state_dict(), *inputs(5)[:2])


def test_bf16_export_matches_the_eager_bf16_sampler(tmp_path):
    """The bf16 artifact (fp32 parameters, bf16 activations) against the
    port's own bf16 sampler on the CPU: bit-equal, fp32 out."""
    _, cfg = small_cfgs(overrides("DF_GEN"))
    ep, template = pexport.export_sampler(cfg, dtype=torch.bfloat16, device="cpu")
    assert all(t.dtype == torch.float32 for t in template.values())
    serve = pexport.load_sampler(pexport.save_sampler(str(tmp_path / "s.pt2"), ep))
    g = make_generator(cfg, torch.bfloat16, device="cpu", seed=4)
    noise, sent, _, _ = inputs(4)
    got = serve(g.state_dict(), noise, sent)
    assert got.dtype == torch.float32 and got.shape == (4, 64, 64, 3)
    assert torch.equal(got, make_sample_fn(cfg, g)(noise, sent).float())


def test_load_sampler_in_a_fresh_process(tmp_path_factory, tmp_path):
    """A fresh interpreter that imports only ``utils.export`` loads the
    word-attention artifact and serves it, equal to this process's result;
    it imports none of the models, nor JAX."""
    gen = "CONCEPT_OUTATTN_GEN"
    _, pserve, _, sd, ep, _ = exported(gen, tmp_path_factory)
    path = pexport.save_sampler(str(tmp_path / "s.pt2"), ep)
    noise, sent, words, mask = inputs(3)
    torch.save({"sd": sd, "args": [torch.from_numpy(a) for a in (noise, sent, words, mask)]},
               tmp_path / "in.pt")
    code = (
        "import json, sys, torch\n"
        "from xmc_gan_tpu_torch.utils.export import load_sampler\n"
        f"d = torch.load({str(tmp_path / 'in.pt')!r})\n"
        f"out = load_sampler({path!r})(d['sd'], *d['args'])\n"
        f"torch.save(out, {str(tmp_path / 'out.pt')!r})\n"
        "print(json.dumps(sorted(sys.modules)))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120, check=True)
    loaded = json.loads(proc.stdout.strip().splitlines()[-1])
    assert not [m for m in loaded if m.startswith(("xmc_gan_tpu_torch.models",
                                                   "xmc_gan_tpu_torch.train", "jax"))]
    assert "xmc_gan_tpu" not in loaded
    assert torch.equal(torch.load(tmp_path / "out.pt"), pserve(sd, noise, sent, words, mask))


def test_load_sampler_checks_its_inputs(tmp_path_factory):
    _, pserve, _, sd, _, _ = exported("CONCEPT_INATTN_GEN", tmp_path_factory)
    noise, sent, words, mask = inputs(2)
    with pytest.raises(ValueError, match="pass words and mask"):
        pserve(sd, noise, sent)
    short = dict(sd)
    short.pop(next(iter(short)))
    with pytest.raises(KeyError, match="do not match"):
        pserve(short, noise, sent, words, mask)
    # the key order of the caller's dict does not matter
    shuffled = dict(reversed(list(sd.items())))
    assert torch.equal(pserve(shuffled, noise, sent, words, mask),
                       pserve(sd, noise, sent, words, mask))


def test_uses_words_matches_jax():
    for gen in FAMILIES + ("CONCEPT_IN_DF_GEN", "CONCEPT_OUT_DF_GEN"):
        jcfg, cfg = small_cfgs(overrides(gen))
        assert pexport.uses_words(cfg) == jexport.uses_words(jcfg) == (gen in WORD_FAMILIES)
