"""Port parity: the Whisper-style encoder-decoder (``arch/encdec.py``) and
the VLM patch projection (llava-next), on the CPU, against the reference.

The same weights (the reference's init, moved through the bridge, every
matrix but the embedding scaled x8) and the same seeded numpy inputs go
through both packages: ``whisper-medium-smoke`` (2 encoder and 2 decoder
layers over 16 frames) and ``llava-next-34b-smoke`` (4 patches of 32).

Tolerances: fp32 to 1e-5 of the output's scale; bf16 to 2e-2 of it.
Greedy tokens must be equal.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.arch.model_zoo import build as jbuild  # noqa: E402
from repro.configs import registry as jreg  # noqa: E402
from repro.serve import engine as je  # noqa: E402
from repro.serve import kvcache as jkv  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.arch import layers as tL  # noqa: E402
from repro_torch.arch.encdec import EncDecModel  # noqa: E402
from repro_torch.arch.model_zoo import build as tbuild  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.launch import serve as tlaunch  # noqa: E402
from repro_torch.serve import engine as te  # noqa: E402
from repro_torch.serve import kvcache as tkv  # noqa: E402

WHISPER, LLAVA = "whisper-medium-smoke", "llava-next-34b-smoke"
REL = {"float32": 1e-5, "bfloat16": 2e-2}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, dtype):
    want = _np(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=REL[dtype] * scale)


def _model(arch, dtype, gain=8.0):
    cfg_j = dataclasses.replace(jreg.get(arch), dtype=dtype)
    cfg_t = dataclasses.replace(treg.get(arch), dtype=dtype)
    tree = jax.tree.map(np.array, jbuild(cfg_j).init(jax.random.PRNGKey(0)))

    def f(path, a):
        key = str(path[-1])
        if a.ndim >= 2 and "scale" not in key and "tok" not in key:
            return (a * gain).astype(a.dtype)
        return a

    tree = jax.tree_util.tree_map_with_path(f, tree)
    return cfg_j, cfg_t, jax.tree.map(jnp.asarray, tree), bridge.params_from_jax(tree, "cpu")


def _inputs(shape, dtype, seed):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(a).astype(dtype), torch.from_numpy(a).to(getattr(torch, dtype))


# ------------------------------------------------------------------ whisper --


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_whisper_encode_prefill_and_decode_against_reference(dtype):
    """``encode``, ``prefill`` (logits, caches, ``enc_out``) and four
    ``decode_step``s, the last two through the decode kernel's plain
    version; the cross K/V are recomputed from ``enc_out`` every step."""
    cfg_j, cfg_t, jp, tp = _model(WHISPER, dtype)
    jm, tm = jbuild(cfg_j), tbuild(cfg_t)
    assert isinstance(tm, EncDecModel)
    fj, ft = _inputs((2, cfg_j.encoder_seq, cfg_j.d_model), dtype, 1)
    _close(tm.encode(tp, ft), jax.jit(jm.encode)(jp, fj), dtype)
    rng = np.random.default_rng(7)
    toks = rng.integers(0, cfg_j.vocab, (2, 4)).astype(np.int32)
    jl, js = jax.jit(jm.prefill)(jp, fj, jnp.asarray(toks), jm.init_caches(2, 16))
    tcaches = tm.init_caches(2, 16, "cpu")
    tl, ts = tm.prefill(tp, ft, torch.from_numpy(toks), tcaches)
    assert ts[0] is tcaches  # written in place
    _close(tl, jl, dtype)
    _close(ts[1], js[1], dtype)
    jdecode = jax.jit(jm.decode_step)
    for i in range(4):
        step = rng.integers(0, cfg_j.vocab, (2, 1)).astype(np.int32)
        jd, js = jdecode(jp, jnp.asarray(step), js)
        disp = tL.Dispatch(attention="flash") if i >= 2 else tL.PLAIN
        td, ts = tm.decode_step(tp, torch.from_numpy(step), ts, dispatch=disp)
        _close(td, jd, dtype)
    _close(ts[0]["k"], js[0]["k"], dtype)
    assert np.array_equal(ts[0]["pos"].numpy(), np.asarray(js[0]["pos"]))
    assert ts[0]["len"].tolist() == np.asarray(js[0]["len"]).tolist()


def test_whisper_greedy_tokens_equal_reference():
    """fp32, weights x40: prefill then eight greedy decode steps in both
    packages give the same tokens."""
    cfg_j, cfg_t, jp, tp = _model(WHISPER, "float32", gain=40.0)
    jm, tm = jbuild(cfg_j), tbuild(cfg_t)
    fj, ft = _inputs((2, cfg_j.encoder_seq, cfg_j.d_model), "float32", 2)
    toks = np.asarray([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)
    jl, js = jax.jit(jm.prefill)(jp, fj, jnp.asarray(toks), jm.init_caches(2, 16))
    tl, ts = tm.prefill(tp, ft, torch.from_numpy(toks), tm.init_caches(2, 16, "cpu"))
    jdecode = jax.jit(jm.decode_step)
    want, got = [], []
    for _ in range(8):
        jt, tt = np.asarray(jnp.argmax(jl, -1)), tl.argmax(-1)
        want.append(jt.tolist())
        got.append(tt.tolist())
        jl, js = jdecode(jp, jnp.asarray(jt[:, None].astype(np.int32)), js)
        tl, ts = tm.decode_step(tp, tt[:, None], ts)
    assert got == want
    assert len({t for row in got for t in row}) > 2


def test_engines_refuse_encdec_as_the_reference():
    """Continuous batching serves decoder-only LMs, in both packages, with
    the same message; ``StaticEngine`` and the launcher refuse too."""
    cfg_j, cfg_t, jp, tp = _model(WHISPER, "float32")
    with pytest.raises(ValueError) as want:
        je.Engine(cfg_j, jp, je.ServeConfig(max_len=32))
    with pytest.raises(ValueError) as got:
        te.Engine(cfg_t, tp, te.ServeConfig(max_len=32), device="cpu")
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError):
        te.StaticEngine(cfg_t, tp, te.ServeConfig(max_len=32), device="cpu")
    with pytest.raises(SystemExit):
        tlaunch.main(["--arch", WHISPER, "--device", "cpu"])


def test_decoder_only_model_refuses_encdec():
    """The port supports encdec through ``EncDecModel``; the decoder-only
    ``Model`` refuses such a config and names where it goes."""
    from repro_torch.arch.transformer import Model, unsupported_reason

    cfg = treg.get(WHISPER)
    assert unsupported_reason(cfg) is None
    assert isinstance(tbuild(cfg), EncDecModel)
    with pytest.raises(NotImplementedError, match="EncDecModel"):
        Model(cfg)


# -------------------------------------------------------------------- llava --


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_llava_prefill_with_patches_and_decode_against_reference(dtype):
    """``prefill(patches=...)``: 4 projected patches before 6 tokens, so
    positions and the caches count 10; then three decode steps; and a
    text-only prefill, as the engine runs it."""
    cfg_j, cfg_t, jp, tp = _model(LLAVA, dtype)
    jm, tm = jbuild(cfg_j), tbuild(cfg_t)
    pj, pt = _inputs((3, cfg_j.n_patches, cfg_j.patch_dim), dtype, 3)
    rng = np.random.default_rng(7)
    toks = rng.integers(0, cfg_j.vocab, (3, 6)).astype(np.int32)
    jc, tc = jkv.build_caches(cfg_j, 3, 32), tkv.build_caches(cfg_t, 3, 32, "cpu")
    jl, jc = jax.jit(jm.prefill)(jp, jnp.asarray(toks), jc, patches=pj)
    tl, tc = tm.prefill(tp, torch.from_numpy(toks), tc, patches=pt)
    _close(tl, jl, dtype)
    assert tc["len"].tolist() == [[10] * 3] * cfg_t.n_layers
    jdecode = jax.jit(jm.decode_step)
    for i in range(3):
        step = rng.integers(0, cfg_j.vocab, (3, 1)).astype(np.int32)
        jd, jc = jdecode(jp, jnp.asarray(step), jc)
        disp = tL.Dispatch(attention="flash") if i == 2 else tL.PLAIN
        td, tc = tm.decode_step(tp, torch.from_numpy(step), tc, dispatch=disp)
        _close(td, jd, dtype)
    jl, _ = jax.jit(jm.prefill)(jp, jnp.asarray(toks), jkv.build_caches(cfg_j, 3, 32))
    tl, _ = tm.prefill(tp, torch.from_numpy(toks), tkv.build_caches(cfg_t, 3, 32, "cpu"))
    _close(tl, jl, dtype)


def test_llava_init_and_engine_serve_text_as_the_reference():
    """The port's init has the reference's tree (``patch_proj`` last); the
    engine serves llava as a text LM with the reference's greedy tokens
    (fp32, weights x40, contiguous: the reference refuses paged for the
    VLM family, and so does the port)."""
    cfg_j, cfg_t, jp, tp = _model(LLAVA, "float32", gain=40.0)
    own = tbuild(cfg_t).init(torch.Generator().manual_seed(0), "cpu")
    assert list(own) == ["embed", "layers", "final_ln", "patch_proj"]
    assert own["patch_proj"].shape == (cfg_t.patch_dim, cfg_t.d_model)
    spec = [(5, 7), (9, 6), (5, 8), (12, 5)]

    def reqs(mod):
        rng = np.random.default_rng(4)
        return [mod.Request(rng.integers(0, cfg_t.vocab, n).astype(np.int32), max_new=m,
                            request_id=i) for i, (n, m) in enumerate(spec)]

    def scfg(mod):
        return mod.ServeConfig(max_len=32, scheduler=mod.SchedulerConfig(batch=2))

    want = je.Engine(cfg_j, jp, scfg(je)).run(reqs(je))
    got = te.Engine(cfg_t, tp, scfg(te), device="cpu").run(reqs(te))
    assert [o.tolist() for o in got] == [o.tolist() for o in want]
    assert len({t for o in got for t in o.tolist()}) > len(spec)
    assert not tkv.supports_paged(cfg_t)
