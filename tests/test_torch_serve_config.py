"""Port parity: ``ServeConfig``'s flat keywords (ROADMAP C3).

Every pre-redesign flat keyword of the reference (``_LEGACY_FLAT``) builds
the same nested config in both packages, with one ``DeprecationWarning``
that names the keywords, reads back through its property, and is
validated by its sub-config as the nested spelling is.  Unknown names
raise ``TypeError``.  The port has no substrate fallback, so a flat
``substrate_fallback=True`` raises and ``False`` is its only behaviour.
"""

import dataclasses
import warnings

import pytest

from repro.serve import engine as je
from repro_torch.serve import engine as te

# one legal non-default value per flat keyword (the paged ones need the
# paged layout beside them)
VALUES = {
    "batch": 3, "prefill_bucket": 16, "prefill_chunk": 16, "token_budget": 32,
    "max_waiting": 5, "stall_patience": 9, "priorities": False,
    "kv_layout": "paged", "block_size": 8, "num_blocks": 40, "prefix_sharing": False,
    "decode_block": 8, "matmul": "pallas", "attention": "xla", "abft": "checksum",
    "scrub_every": 4, "snapshot_dir": "snaps", "snapshot_every": 7, "snapshot_keep": 2,
    "journal_fsync_every": 3, "guard_nan": False, "kv_checksum": True,
    "substrate_fallback": False,
}
NEEDS = {
    "token_budget": {"prefill_chunk": 16}, "num_blocks": {"kv_layout": "paged"},
    "abft": {"kv_layout": "paged"}, "kv_checksum": {"kv_layout": "paged"},
}


def _nested(cfg):
    """The nested sub-configs as field dicts, without the reference's
    substrate_fallback (the port has none)."""
    out = {}
    for sub in ("scheduler", "kv", "kernel", "durability"):
        d = dataclasses.asdict(getattr(cfg, sub))
        d.pop("substrate_fallback", None)
        out[sub] = d
    return out, (cfg.max_len, cfg.temperature, cfg.seed)


def _build(mod, **kw):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        cfg = mod.ServeConfig(max_len=64, **kw)
    return cfg, [str(w.message) for w in caught if w.category is DeprecationWarning]


def test_legacy_names_are_the_references():
    assert te._LEGACY_FLAT == je._LEGACY_FLAT


@pytest.mark.parametrize("name", sorted(je._LEGACY_FLAT))
def test_each_flat_keyword_builds_the_references_nested_config(name):
    kw = {**NEEDS.get(name, {}), name: VALUES[name]}
    jc, jw = _build(je, **kw)
    tc, tw = _build(te, **kw)
    assert _nested(tc) == _nested(jc)
    assert tw == jw and len(tw) == 1 and name in tw[0]
    assert getattr(tc, name) == VALUES[name]
    if name != "scrub_every":  # the reference reads this one back only nested
        assert getattr(jc, name) == VALUES[name]


def test_flat_and_nested_spellings_agree_and_nested_does_not_warn():
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        nested = te.ServeConfig(max_len=32, scheduler=te.SchedulerConfig(batch=2))
    flat, msgs = _build(te, batch=2)
    assert dataclasses.replace(flat, max_len=32) == nested
    assert msgs and flat.batch == nested.batch == 2
    assert te.ServeConfig(max_len=32).substrate_fallback is False


@pytest.mark.parametrize("kw", [
    dict(batch=0), dict(kv_layout="ring"), dict(kv_layout="paged", block_size=0),
    dict(matmul="triton"), dict(scrub_every=0), dict(snapshot_every=0),
    dict(token_budget=8), dict(abft="checksum"), dict(kv_layout="paged", block_size=48),
    dict(prefill_chunk=48),
])
def test_flat_keywords_raise_as_the_reference(kw):
    """The same check refuses the same value in both packages (the
    messages' wording differs)."""
    for mod in (je, te):
        with pytest.raises(ValueError):
            _build(mod, **kw)


def test_unknown_keyword_raises_type_error_as_the_reference():
    for mod in (je, te):
        with pytest.raises(TypeError, match="unexpected kwargs: bogus, zz"):
            mod.ServeConfig(zz=1, bogus=2)


def test_flat_substrate_fallback_true_raises():
    with pytest.raises(TypeError):
        te.DurabilityConfig(substrate_fallback=True)
    with pytest.raises(ValueError, match="no substrate fallback"):
        _build(te, substrate_fallback=True)
