"""The port's perf switches and perf harness against the JAX package's, and
the file-for-file coverage of the port: every module of ``src/repro`` has
its counterpart in ``src/repro_torch``, and every public name of the
model modules exists there.
"""
import ast
import importlib
import os
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import dryrun as DR  # noqa: E402
from repro_torch.launch import perf as PF  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import Model, decode_step, prefill  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import params as P  # noqa: E402

REPO = Path(__file__).resolve().parents[1]


def ref_module(name):
    """Import a reference launch module without leaving its XLA_FLAGS (it
    sets 512 host devices at import)."""
    old = os.environ.get("XLA_FLAGS")
    try:
        return importlib.import_module(name)
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old


@pytest.fixture(autouse=True)
def _switches_off():
    """Every test starts and ends with the switches at their defaults."""
    saved = PF.switches()
    torch.set_num_threads(1)
    yield
    PF._restore(saved)
    assert (L.FLASH_BF16, L.CACHE_UPDATE_MASKED, L.DECODE_SHARD, M.SEQ_SHARD_ACTS,
            L.INNER_SCAN_UNROLL, P.DEFAULT_RULES["embed"]) == (
        False, False, None, True, False, "data")


# ----------------------------------------------------------------------
# coverage: the port does everything the JAX package does
# ----------------------------------------------------------------------
def _public(path: Path):
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
    return {n for n in names if not n.startswith("_")}


def test_every_reference_module_has_a_counterpart():
    ref, port = REPO / "src" / "repro", REPO / "src" / "repro_torch"
    missing = [str(p.relative_to(ref)) for p in sorted(ref.rglob("*.py"))
               if "__pycache__" not in p.parts and not (port / p.relative_to(ref)).exists()]
    assert not missing, f"no counterpart in src/repro_torch for {missing}"


@pytest.mark.parametrize("module", ["models/layers.py", "models/model.py"])
def test_model_modules_have_every_public_name(module):
    ref = _public(REPO / "src" / "repro" / module)
    port = _public(REPO / "src" / "repro_torch" / module)
    assert not sorted(ref - port), f"{module}: the port lacks {sorted(ref - port)}"


# ----------------------------------------------------------------------
# the switches
# ----------------------------------------------------------------------
def test_switch_defaults_and_setters_match_reference():
    from repro.models import layers as RLy
    from repro.models import model as RM
    for name in ("FLASH_BF16", "CACHE_UPDATE_MASKED", "INNER_SCAN_UNROLL"):
        assert getattr(L, name) == getattr(RLy, name)
    assert M.SEQ_SHARD_ACTS == RM.SEQ_SHARD_ACTS
    for setter, flag, mod in (("set_flash_bf16", "FLASH_BF16", L),
                              ("set_cache_update_masked", "CACHE_UPDATE_MASKED", L),
                              ("set_inner_unroll", "INNER_SCAN_UNROLL", L),
                              ("set_seq_shard_acts", "SEQ_SHARD_ACTS", M)):
        getattr(mod, setter)(1)
        assert getattr(mod, flag) is True
        getattr(mod, setter)(0)
        assert getattr(mod, flag) is False
    M.set_seq_shard_acts(True)


def test_masked_cache_write_is_bit_equal():
    import jax.numpy as jnp
    from repro.models import layers as RLy
    rng = np.random.default_rng(0)
    cache = rng.standard_normal((2, 16, 4, 8)).astype(np.float32)
    new = rng.standard_normal((2, 1, 4, 8)).astype(np.float32) * 3
    for dtype, jdt in ((torch.bfloat16, jnp.bfloat16), (torch.float32, jnp.float32)):
        c = torch.from_numpy(cache).to(dtype)
        for pos in (0, 5, 15):
            plain = L._cache_write(c, torch.from_numpy(new), pos)
            L.set_cache_update_masked(True)
            RLy.set_cache_update_masked(True)
            try:
                masked = L._cache_write(c, torch.from_numpy(new), pos)
                ref = RLy._cache_write(jnp.asarray(cache, jdt), jnp.asarray(new), jnp.int32(pos))
            finally:
                L.set_cache_update_masked(False)
                RLy.set_cache_update_masked(False)
            assert torch.equal(plain, masked)
            np.testing.assert_array_equal(masked.float().numpy(), np.asarray(ref, np.float32))


def test_masked_cache_decode_logits_bit_equal():
    cfg = get_config("internlm2-1.8b", smoke=True)
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 8), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        logits, cache = prefill(model, params, {"tokens": tokens}, max_len=16)
        tok = logits[:, -1:].argmax(-1).to(torch.int32)
        a, _ = decode_step(model, params, cache, tok)
        L.set_cache_update_masked(True)
        b, _ = decode_step(model, params, cache, tok)
    assert torch.equal(a, b)


def _flash_inputs():
    import jax
    import jax.numpy as jnp
    q = jax.random.normal(jax.random.PRNGKey(3), (2, 16, 4, 16), jnp.bfloat16)
    k = jax.random.normal(jax.random.PRNGKey(4), (2, 16, 2, 16), jnp.bfloat16)
    v = jax.random.normal(jax.random.PRNGKey(5), (2, 16, 2, 16), jnp.bfloat16)
    to_t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).bfloat16()
    return (q, k, v), tuple(map(to_t, (q, k, v)))


def test_flash_bf16_close_to_fp32_and_to_the_reference():
    """The reference test's inputs: bf16 flash within its 5e-2 of fp32, and
    within 1e-3·(1+|x|) of the reference's bf16 flash (the CPU path: the
    bf16-rounded operands upcast to one fp32 GEMM, as XLA's CPU dot runs
    them)."""
    from repro.models import layers as RLy
    (jq, jk, jv), (q, k, v) = _flash_inputs()
    fp32 = L.flash_attention(q, k, v, causal=True, kv_chunk=8).float()
    L.set_flash_bf16(True)
    RLy.set_flash_bf16(True)
    try:
        bf16 = L.flash_attention(q, k, v, causal=True, kv_chunk=8).float()
        ref = np.asarray(RLy.flash_attention(jq, jk, jv, causal=True, kv_chunk=8), np.float32)
        rng = np.random.default_rng(0)
        qf, kf, vf = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                      for s in ((2, 24, 4, 16), (2, 24, 2, 16), (2, 24, 2, 16)))
        bf16_f = L.flash_attention(qf, kf, vf, causal=True, kv_chunk=8).numpy()
        ref_f = np.asarray(RLy.flash_attention(*(np.asarray(t) for t in (qf, kf, vf)),
                                               causal=True, kv_chunk=8))
    finally:
        RLy.set_flash_bf16(False)
    np.testing.assert_allclose(bf16.numpy(), fp32.numpy(), rtol=5e-2, atol=5e-2)
    for got, want in ((bf16.numpy(), ref), (bf16_f, ref_f)):
        assert np.all(np.abs(got - want) <= 1e-3 * (1 + np.abs(want)))


def test_flash_bf16_backward_close_to_fp32():
    """The bf16 GEMMs' backward (grads of bf16 operands, fp32 accumulation)
    stays within the 5e-2 rule of the fp32 flash's grads."""
    _, (q, k, v) = _flash_inputs()
    grads = []
    for flag in (False, True):
        L.set_flash_bf16(flag)
        ins = [t.float().requires_grad_() for t in (q, k, v)]
        out = L.flash_attention(*ins, causal=True, kv_chunk=8)
        grads.append(torch.autograd.grad(out.square().sum(), ins))
    for a, b in zip(*grads):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=5e-2, atol=5e-2)


def test_seq_shard_acts_off_changes_no_value():
    cfg = get_config("internlm2-1.8b", smoke=True)
    mesh = make_mesh((1, 2), ("data", "model"), ["cpu"] * 2)
    model = Model(cfg, mesh=mesh)
    whole = Model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    params = model.param_layout().shard(whole)
    tokens = torch.randint(0, cfg.vocab_size, (2, 8), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        on = model.forward(params, {"tokens": tokens})
        M.set_seq_shard_acts(False)
        off = model.forward(params, {"tokens": tokens})
    assert torch.equal(on, off)


# ----------------------------------------------------------------------
# the perf harness
# ----------------------------------------------------------------------
VARIANTS = ["baseline", "flash_bf16", "masked_cache", "decode_shard", "serve_weights",
            "seq_acts=0", "mu=4", "pad_heads=32", "kv_chunk=1024",
            "masked_cache+flash_bf16+seq_acts=0+mu=2+pad_heads=48+kv_chunk=512"]


@pytest.mark.parametrize("variant", VARIANTS)
def test_apply_variant_equals_reference(variant):
    ref_pf = ref_module("repro.launch.perf")
    from repro.configs import get_config as ref_config
    from repro.models import layers as RLy
    from repro.models import model as RM
    from repro.models import params as RP
    try:
        for arch in ("starcoder2-15b", "internlm2-1.8b"):
            cfg, kv_chunk, mu = PF.apply_variant(get_config(arch), variant)
            rcfg, r_kv, r_mu = ref_pf.apply_variant(ref_config(arch), variant)
            assert (cfg.num_heads, cfg.num_kv_heads, kv_chunk, mu) == \
                (rcfg.num_heads, rcfg.num_kv_heads, r_kv, r_mu)
            assert (L.FLASH_BF16, L.CACHE_UPDATE_MASKED, M.SEQ_SHARD_ACTS,
                    P.DEFAULT_RULES["embed"]) == (RLy.FLASH_BF16, RLy.CACHE_UPDATE_MASKED,
                                                  RM.SEQ_SHARD_ACTS, RP.DEFAULT_RULES["embed"])
            for to in (32, 48):
                p, r = PF.pad_heads_cfg(cfg, to), ref_pf.pad_heads_cfg(rcfg, to)
                assert (p.num_heads, p.num_kv_heads) == (r.num_heads, r.num_kv_heads)
    finally:
        RLy.set_flash_bf16(False)
        RLy.set_cache_update_masked(False)
        RM.set_seq_shard_acts(True)
        RP.DEFAULT_RULES["embed"] = "data"


def test_apply_variant_refuses_an_unknown_knob():
    with pytest.raises(ValueError, match="unknown knob"):
        PF.apply_variant(get_config("internlm2-1.8b"), "flash_bf16+warp_speed")


@pytest.mark.parametrize("fails", [False, True])
def test_run_variant_leaves_every_switch_as_found(monkeypatch, fails):
    L.set_inner_unroll(True)
    M.set_seq_shard_acts(False)
    before = PF.switches()
    seen = {}

    def cell(arch, shape_name, *, multi_pod, kv_chunk, verbose):
        seen.update(PF.switches(), kv_chunk=kv_chunk, cfg=DR.get_config(arch),
                    mu=DR.pick_microbatches(None, None, None))
        if fails:
            raise RuntimeError("the cell failed")
        return {"status": "ok"}

    monkeypatch.setattr(DR, "run_cell", cell)
    variant = "flash_bf16+masked_cache+seq_acts=0+serve_weights+decode_shard+mu=2+" \
              "pad_heads=32+kv_chunk=512"
    if fails:
        with pytest.raises(RuntimeError):
            PF.run_variant("internlm2-1.8b", "decode_32k", variant)
    else:
        assert PF.run_variant("internlm2-1.8b", "decode_32k", variant)["variant"] == variant
    assert seen["flash_bf16"] and seen["cache_update_masked"] and not seen["seq_shard_acts"]
    assert seen["embed_rule"] is None and seen["decode_shard"] is not None
    assert (seen["kv_chunk"], seen["mu"], seen["cfg"].num_heads) == (512, 2, 32)
    assert PF.switches() == before
    with pytest.raises(ValueError):
        PF.run_variant("internlm2-1.8b", "decode_32k", "flash_bf16+nope")
    assert PF.switches() == before
