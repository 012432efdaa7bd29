"""Model-zoo parity: the port's ``forward``, ``prefill`` and ``decode_step``
against the JAX package's, for all ten architectures at their smoke
configs, with the reference's parameters carried across by
``params_from_numpy``.

Parameters and inputs are drawn with numpy from a seed (every leaf random,
the zero- and one-initialised ones too, so gates, ``a_log`` and the norms
are exercised).  The reference runs as its own tests run it, on the CPU.

Tolerances, on max |Δ| / max |reference| of logits and caches:
  * both trees in fp32: ``FP32_RTOL`` = 1e-4 (measured ≤ 1e-6);
  * the shipped bf16: ``BF16_RTOL`` = 0.05 (measured ≤ 0.022, zamba2 — a
    bf16 rounding is 2^-8 of a value and the two packages round different
    partial sums), and greedy tokens equal wherever the reference's top-1 /
    top-2 gap exceeds twice that tolerance.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS, get_config as j_get_config  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.models import count_params as j_count_params  # noqa: E402
from repro.models import decode_step as j_decode_step  # noqa: E402
from repro.models import init_cache as j_init_cache  # noqa: E402
from repro.models import prefill as j_prefill  # noqa: E402
from repro.models import moe as j_moe  # noqa: E402
from repro.models import ssm as j_ssm  # noqa: E402
from repro.models.params import ParamInfo as JParamInfo  # noqa: E402
from repro_torch.configs import ARCHS as T_ARCHS  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.models import (Model as TModel, cache_shapes, count_params,  # noqa: E402
                                decode_step, init_cache, named_params,
                                params_from_numpy, prefill)
from repro_torch.models import moe as t_moe  # noqa: E402
from repro_torch.models import ssm as t_ssm  # noqa: E402

B, S, KV_CHUNK = 2, 16, 8
FP32_RTOL = 1e-4
BF16_RTOL = 0.05


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep the port's small CPU tests to one thread: the suite runs beside
    timing-sensitive socket tests in other worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ----------------------------------------------------------------------
# carrying parameters and inputs across
# ----------------------------------------------------------------------
def numpy_params(infos, rng, fp32: bool):
    """A reference-layout tree of fp32 numpy leaves drawn from ``rng``; with
    ``fp32=False`` each leaf is rounded to its ParamInfo dtype (bf16 values
    held exactly in fp32)."""
    if isinstance(infos, JParamInfo):
        x = rng.standard_normal(infos.shape).astype(np.float32)
        x = {"ones": 1.0 + 0.1 * x, "zeros": 0.5 * x}.get(infos.init, x * infos.scale)
        return x if fp32 else x.astype(infos.dtype).astype(np.float32)
    return {k: numpy_params(v, rng, fp32) for k, v in infos.items()}


def jax_params(tree, infos, fp32: bool):
    """The numpy tree as the reference's parameters (fp32, or each leaf's
    dtype)."""
    if isinstance(infos, JParamInfo):
        return jnp.asarray(tree.astype(np.float32 if fp32 else infos.dtype))
    return {k: jax_params(tree[k], v, fp32) for k, v in infos.items()}


def both_params(arch, seed, fp32, smoke=True):
    """(reference model, its params, port model, its params, numpy tree)."""
    jm, tm = JModel(j_get_config(arch, smoke)), TModel(t_get_config(arch, smoke))
    tree = numpy_params(jm.infos(), np.random.default_rng(seed), fp32)
    tp = params_from_numpy(tree, tm.infos(), device="cpu",
                           dtype=torch.float32 if fp32 else None)
    return jm, jax_params(tree, jm.infos(), fp32), tm, tp, tree


def both_batches(cfg, rng, batch, seq, fp32):
    """The same batch for both packages: tokens, and the encdec / vlm stub
    embeddings in the parameters' precision."""
    tokens = rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32)
    extra = {}
    if cfg.family == "encdec":
        extra["frames"] = rng.standard_normal((batch, seq, cfg.d_model))
    if cfg.family == "vlm":
        extra["image_embeds"] = rng.standard_normal(
            (batch, cfg.num_image_tokens, cfg.d_model))
    jdt, tdt = (jnp.float32, torch.float32) if fp32 else (jnp.bfloat16, torch.bfloat16)
    extra = {k: v.astype(np.float32) for k, v in extra.items()}
    jb = {"tokens": jnp.asarray(tokens),
          **{k: jnp.asarray(v).astype(jdt) for k, v in extra.items()}}
    tb = {"tokens": torch.from_numpy(tokens),
          **{k: torch.from_numpy(v).to(tdt) for k, v in extra.items()}}
    return jb, tb


def rel_err(ref, got) -> float:
    ref = np.asarray(ref, np.float32)
    got = got.float().numpy() if torch.is_tensor(got) else np.asarray(got, np.float32)
    assert ref.shape == got.shape, (ref.shape, got.shape)
    return float(np.abs(ref - got).max() / max(np.abs(ref).max(), 1e-30))


def assert_greedy_agrees(ref_logits, got_logits, tol_abs):
    """Greedy tokens equal wherever the reference's top-1/top-2 gap exceeds
    ``2 * tol_abs``."""
    ref = np.asarray(ref_logits, np.float32).reshape(-1, ref_logits.shape[-1])
    got = got_logits.float().numpy().reshape(ref.shape)
    top2 = np.sort(ref, axis=-1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > 2 * tol_abs
    assert (ref.argmax(-1)[clear] == got.argmax(-1)[clear]).all()


# ----------------------------------------------------------------------
# forward / prefill / decode, all ten architectures
# ----------------------------------------------------------------------
@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_decode_match_reference(arch, precision):
    fp32 = precision == "fp32"
    jm, jp, tm, tp, _ = both_params(arch, 0, fp32)
    cfg = jm.cfg
    jb, tb = both_batches(cfg, np.random.default_rng(1), B, S, fp32)

    @jax.jit
    def reference(p, b):
        full = jm.forward(p, b, kv_chunk=KV_CHUNK)
        lp, c0 = j_prefill(jm, p, {**b, "tokens": b["tokens"][:, :S - 1]},
                           max_len=S + 2, kv_chunk=KV_CHUNK)
        l1, c1 = j_decode_step(jm, p, c0, b["tokens"][:, S - 1:])
        t2 = jnp.argmax(l1[:, -1], -1)[:, None].astype(jnp.int32)
        l2, c2 = j_decode_step(jm, p, c1, t2)
        return full, lp, c0, l1, l2, c2, t2

    full, lp, c0, l1, l2, c2, t2 = reference(jp, jb)
    t_full = tm(tp, tb, kv_chunk=KV_CHUNK)
    t_lp, t_c0 = prefill(tm, tp, {**tb, "tokens": tb["tokens"][:, :S - 1]},
                         max_len=S + 2, kv_chunk=KV_CHUNK)
    t_l1, t_c1 = decode_step(tm, tp, t_c0, tb["tokens"][:, S - 1:])
    t_l2, t_c2 = decode_step(tm, tp, t_c1, torch.from_numpy(np.array(t2)))

    rtol = FP32_RTOL if fp32 else BF16_RTOL
    for name, ref, got in (("forward", full, t_full), ("prefill", lp, t_lp),
                           ("decode 1", l1, t_l1), ("decode 2", l2, t_l2)):
        assert got.dtype == (torch.float32 if fp32 else torch.bfloat16), name
        assert rel_err(ref, got) <= rtol, (name, rel_err(ref, got))
        if not fp32:
            assert_greedy_agrees(ref, got, rtol * float(np.abs(np.asarray(
                ref, np.float32)).max()))
    # the prefill cache and the cache after two decode steps
    assert int(c0["len"]) == t_c0["len"] == S - 1 and t_c2["len"] == S + 1
    for cache, t_cache in ((c0, t_c0), (c2, t_c2)):
        assert set(cache) == set(t_cache)
        for key in cache:
            if key != "len":
                assert rel_err(cache[key], t_cache[key]) <= rtol, key


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_shapes_match_reference(arch):
    """``cache_shapes`` / ``init_cache``: the reference's layout — bf16
    caches, fp32 SSM states — at the engine's sizes."""
    cfg = j_get_config(arch, smoke=True)
    enc = 12 if cfg.family == "encdec" else 0
    img = cfg.num_image_tokens if cfg.family == "vlm" else 0
    ref = j_init_cache(cfg, 3, 20, enc_len=enc, img_len=img)
    got = init_cache(t_get_config(arch, smoke=True), 3, 20, enc_len=enc,
                     img_len=img, device="cpu")
    spec = cache_shapes(t_get_config(arch, smoke=True), 3, 20, enc, img)
    assert set(ref) == set(got) == set(spec)
    for key, arr in ref.items():
        assert tuple(arr.shape) == spec[key].shape
        assert str(arr.dtype) == str(spec[key].dtype).replace("torch.", "")
        if key != "len":
            assert tuple(got[key].shape) == tuple(arr.shape)
            assert got[key].dtype == spec[key].dtype and not got[key].any()
    assert got["len"] == 0


@pytest.mark.parametrize("arch", ARCHS)
def test_count_params_full_configs(arch):
    """Full configs count as the reference counts them, from the spec
    trees alone (nothing materialised)."""
    assert T_ARCHS == ARCHS
    tcfg, jcfg = t_get_config(arch), j_get_config(arch)
    assert tcfg.to_json() == jcfg.to_json()
    assert count_params(TModel(tcfg).infos()) == j_count_params(JModel(jcfg).infos())


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "llama-3.2-vision-90b"])
def test_params_unstack_one_to_one(arch):
    """Dotted names map 1:1 onto the reference's stacked leaves, the second
    stacked dim of the hybrid and vlm groups included; a bf16 numpy tree
    (``np.asarray`` of a JAX bf16 array) carries across exactly."""
    jm, jp, tm, tp, tree = both_params(arch, 2, fp32=False)
    names = named_params(tp)
    assert count_params(tp) == j_count_params(jp)
    g, i = 1, 0
    w = tree["layers"]["ssm" if arch.startswith("zamba") else "attn"]
    key = "w_xz" if arch.startswith("zamba") else "wq"
    path = f"layers.{g}.{i}.{'ssm' if arch.startswith('zamba') else 'attn'}.{key}"
    np.testing.assert_array_equal(names[path].float().numpy(), w[key][g][i])
    bf16_tree = jax.tree_util.tree_map(np.asarray, jp)
    again = params_from_numpy(bf16_tree, tm.infos(), device="cpu")
    for a, b in zip(named_params(again).values(), names.values()):
        assert a.dtype == b.dtype and torch.equal(a, b)


# ----------------------------------------------------------------------
# MoE dispatch and the SSD decode state
# ----------------------------------------------------------------------
def test_moe_local_drops_and_ties():
    """Capacity drops (later tokens first) and tied router probabilities
    (lower expert id first, as ``lax.top_k``) pick exactly the reference's
    (token, expert) pairs."""
    jm, jp, tm, tp, tree = both_params("olmoe-1b-7b", 3, fp32=True)
    cfg = jm.cfg
    p_np = {k: v[0] for k, v in tree["layers"]["moe"].items()}
    p_np["router"][:, 3] = p_np["router"][:, 2]       # experts 2 and 3 tie
    p_np["router"][:, 2] *= 4.0                        # ... and are often chosen
    p_np["router"][:, 3] = p_np["router"][:, 2]
    x = np.random.default_rng(4).standard_normal((40, cfg.d_model)).astype(np.float32)
    cf = 0.5            # capacity min(T, max(ceil(T k / E cf), 8)) = 8 < T k / E
    assert t_moe._capacity(40, 2, 8, cf) == 8
    j_moe_local = jax.jit(lambda p, x: j_moe.moe_local(p, x, cfg, capacity_factor=cf))
    ref = j_moe_local({k: jnp.asarray(v) for k, v in p_np.items()}, jnp.asarray(x))
    got = t_moe.moe_local({k: torch.from_numpy(v) for k, v in p_np.items()},
                          torch.from_numpy(x), t_get_config("olmoe-1b-7b", True),
                          capacity_factor=cf)
    assert rel_err(ref, got) <= FP32_RTOL
    # the case is live: experts 2 and 3 tie on every token, and they overflow
    probs = torch.softmax(torch.from_numpy(x) @ torch.from_numpy(p_np["router"]), -1)
    assert torch.equal(probs[:, 2], probs[:, 3])
    _, top_i = t_moe._top_k(probs, 2)
    rows = top_i.tolist()
    assert sum(3 in r for r in rows) > 8
    assert all(r.index(2) < r.index(3) for r in rows if 3 in r)
    # and agree in bf16 too
    got16 = t_moe.moe_local({k: torch.from_numpy(v).to(
        torch.float32 if k == "router" else torch.bfloat16) for k, v in p_np.items()},
        torch.from_numpy(x).bfloat16(), t_get_config("olmoe-1b-7b", True),
        capacity_factor=cf)
    ref16 = j_moe_local({k: jnp.asarray(v).astype(
        jnp.float32 if k == "router" else jnp.bfloat16) for k, v in p_np.items()},
        jnp.asarray(x).astype(jnp.bfloat16))
    assert rel_err(ref16, got16) <= BF16_RTOL


def test_ssd_decode_state_after_prefill():
    """The SSD state after a chunked prefill, and one recurrent step from it,
    match the reference; the step equals the prefill of one more token."""
    jm, jp, tm, tp, tree = both_params("mamba2-780m", 5, fp32=True)
    cfg, tcfg = jm.cfg, tm.cfg
    p_np = {k: v[0] for k, v in tree["layers"]["ssm"].items()}
    jp1 = {k: jnp.asarray(v) for k, v in p_np.items()}
    tp1 = {k: torch.from_numpy(v) for k, v in p_np.items()}
    x = np.random.default_rng(6).standard_normal((B, 33, cfg.d_model)).astype(np.float32)
    @jax.jit
    def reference(p, x):
        _, st = j_ssm.ssd_forward_with_state(p, x[:, :32], cfg)
        return (st,) + j_ssm.ssd_decode(p, x[:, 32:], st, cfg)

    j_st, j_y, j_st2 = reference(jp1, jnp.asarray(x))
    _, t_st = t_ssm.ssd_forward_with_state(tp1, torch.from_numpy(x[:, :32]), tcfg)
    assert rel_err(j_st.h, t_st.h) <= FP32_RTOL
    assert rel_err(j_st.conv, t_st.conv) <= FP32_RTOL
    t_y, t_st2 = t_ssm.ssd_decode(tp1, torch.from_numpy(x[:, 32:]), t_st, tcfg)
    assert rel_err(j_y, t_y) <= FP32_RTOL
    assert rel_err(j_st2.h, t_st2.h) <= FP32_RTOL
    assert rel_err(j_st2.conv, t_st2.conv) <= FP32_RTOL
    full, _ = t_ssm.ssd_forward_with_state(tp1, torch.from_numpy(x), tcfg.replace(
        ssm_chunk=11))
    assert rel_err(full[:, 32:].numpy(), t_y) <= 1e-4
