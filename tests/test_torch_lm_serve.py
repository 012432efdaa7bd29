"""The LM serving plane against the JAX package: the slot ``Engine``, the
``TokenPipeline`` and the kNN-LM flow of ``examples/knn_lm.py``, at smoke
widths on the CPU.

* ``Engine``: both packages' engines drain the same requests (mixed prompt
  lengths, so a shorter slot decodes at its longer neighbour's shared
  position, as the reference does) from the same fp32 parameter trees; the
  generated tokens must be equal.  fp32 trees keep greedy choices away from
  bf16 near-ties; both engines' caches are bf16, as the reference has them.
* ``TokenPipeline``: its contract (deterministic in (seed, step), constant-
  time seek, host slices reproducible alone) and, through a draws hook that
  replays ``jax.random``, the reference's batches exactly.
* kNN-LM: the datastore of hidden-state proxies agrees with the reference's
  to ``BF16_RTOL`` (bf16 parameters, as the example builds them); both
  indexes are built from the reference's datastore with the reference's
  draws and must answer the reference's query embeddings with equal gids
  (distances within 1e-5·(‖q‖²+‖x‖²)); the interpolated next-token
  distributions agree within ``MIX_ATOL`` and each sums to 1.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from test_torch_index import reference_draws  # noqa: E402
from test_torch_models import BF16_RTOL, both_params, rel_err  # noqa: E402

from repro.core import build_index as j_build_index  # noqa: E402
from repro.core import knn_query as j_knn_query  # noqa: E402
from repro.data.tokens import TokenPipeline as JPipeline  # noqa: E402
from repro.serve import Engine as JEngine, Request as JRequest  # noqa: E402
from repro.utils.config import ClimberConfig as JConfig  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.core import build_index as t_build_index  # noqa: E402
from repro_torch.core import knn_query as t_knn_query  # noqa: E402
from repro_torch.data import TokenDraws, TokenPipeline  # noqa: E402
from repro_torch.serve import Engine, Request  # noqa: E402
from repro_torch.utils.config import ClimberConfig as TConfig  # noqa: E402

MIX_ATOL = 1e-4     # |Δp| of the interpolated distributions (measured 7.7e-6)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep the port's small CPU tests to one thread: the suite runs beside
    timing-sensitive socket tests in other worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class JaxTokenDraws(TokenDraws):
    """Replays ``repro.data.tokens.TokenPipeline``'s ``jax.random`` draws:
    ``fold_in(PRNGKey(seed), step)`` split three ways, the token key folded
    with the slice's first row."""

    @staticmethod
    def _keys(seed, step):
        return jax.random.split(jax.random.fold_in(jax.random.PRNGKey(seed), step), 3)

    def tokens(self, seed, step, lo, n, length, vocab):
        kt = jax.random.fold_in(self._keys(seed, step)[0], lo)
        return np.asarray(jax.random.randint(kt, (n, length), 0, vocab, jnp.int32))

    def phase(self, seed, step, lo, n, vocab):
        kt = jax.random.fold_in(self._keys(seed, step)[0], lo)
        return np.asarray(jax.random.randint(kt, (n, 1), 0, vocab))

    def frames(self, seed, step, n, length, d):
        return np.asarray(jax.random.normal(self._keys(seed, step)[1], (n, length, d),
                                            jnp.float32))

    def image_embeds(self, seed, step, n, tokens, d):
        return np.asarray(jax.random.normal(self._keys(seed, step)[2], (n, tokens, d),
                                            jnp.float32))


# ----------------------------------------------------------------------
# the slot engine
# ----------------------------------------------------------------------
def drain(engine_cls, request_cls, model, params, prompts, **kw):
    eng = engine_cls(model, params, slots=2, max_len=64, **kw)
    for i, p in enumerate(prompts):
        eng.submit(request_cls(rid=i, prompt=p, max_new_tokens=6 + i))
    reqs = list(eng.queue)
    eng.run_until_drained(max_ticks=200)
    assert not eng.queue and all(r.done for r in reqs)
    return eng, [r.generated for r in reqs]


@pytest.mark.parametrize("arch, lens", [("internlm2-1.8b", (8, 13, 5, 20)),
                                        ("mamba2-780m", (16, 32, 16, 48)),
                                        ("zamba2-2.7b", (16, 32, 48, 16))])
def test_engine_matches_reference(arch, lens):
    """Four requests through two slots: prefill alone at batch 1, the slot
    insert, ``len`` reset after an admit, every tick at the longest live
    length — the reference's tokens, one for one.  (The SSM archs' prompt
    lengths are multiples of their ``ssm_chunk``, which the chunked prefill
    needs.)"""
    jm, jp, tm, tp, _ = both_params(arch, 0, fp32=True)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, jm.cfg.vocab_size, n).astype(np.int32) for n in lens]
    _, ref = drain(JEngine, JRequest, jm, jp, prompts)
    eng, got = drain(Engine, Request, tm, tp, prompts, device="cpu")
    assert got == ref
    st = eng.stats
    assert st.prefills == len(lens) and st.tokens == sum(len(g) for g in got)
    assert st.ticks >= max(len(g) for g in got) - 1 and st.decode_s > 0 < st.prefill_s


def test_engine_shared_len_couples_slots():
    """The reference's shared decode position: beside a 30-token prompt, a
    5-token one writes its next K at position 30, after 25 zero-filled pad
    positions that its attention does not mask."""
    _, _, tm, tp, _ = both_params("internlm2-1.8b", 0, fp32=True)
    rng = np.random.default_rng(3)
    eng = Engine(tm, tp, slots=2, max_len=64, device="cpu")
    for i, n in enumerate((5, 30)):
        eng.submit(Request(rid=i, prompt=rng.integers(0, 256, n).astype(np.int32)))
    eng.step()
    k_short = eng.cache["k"][:, 0].float().abs().sum((0, 2, 3))     # per position
    assert bool((k_short[:5] > 0).all()) and bool((k_short[5:30] == 0).all())
    assert float(k_short[30]) > 0 and eng.cache["len"] == 31


def test_encdec_engine_needs_max_len_prompts():
    """An encdec engine serves prompts of exactly ``max_len`` tokens (its
    cross-attention cache is sized at ``max_len``) and refuses others, as
    the reference does.  bf16 trees: the engine's stub frames are bf16."""
    jm, jp, tm, tp, _ = both_params("whisper-large-v3", 0, fp32=False)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 256, 64).astype(np.int32) for _ in range(2)]
    _, ref = drain(JEngine, JRequest, jm, jp, prompts)
    _, got = drain(Engine, Request, tm, tp, prompts, device="cpu")
    assert got == ref and [len(g) for g in got] == [2, 2]
    eng = Engine(tm, tp, slots=2, max_len=64, device="cpu")
    eng.submit(Request(rid=0, prompt=prompts[0][:9]))
    with pytest.raises(ValueError, match="max_len"):
        eng.step()


def test_engine_refuses_parameters_on_another_device():
    _, _, tm, tp, _ = both_params("internlm2-1.8b", 0, fp32=True)
    with pytest.raises(ValueError, match="parameter lies on cpu"):
        Engine(tm, tp, device="meta")


# ----------------------------------------------------------------------
# the token pipeline
# ----------------------------------------------------------------------
def test_pipeline_contract():
    cfg = t_get_config("whisper-large-v3", smoke=True)
    pipe = TokenPipeline(cfg, global_batch=6, seq_len=10, seed=3, device="cpu")
    a, b = pipe.batch_at(5), TokenPipeline(cfg, 6, 10, seed=3, device="cpu").batch_at(5)
    assert set(a) == {"tokens", "frames"}
    assert a["tokens"].shape == (6, 11) and a["tokens"].dtype == torch.int32
    assert a["frames"].shape == (6, 10, cfg.d_model) and a["frames"].dtype == torch.bfloat16
    assert all(torch.equal(a[k], b[k]) for k in a)                  # deterministic, O(1) seek
    assert not torch.equal(a["tokens"], pipe.batch_at(6)["tokens"])
    assert not torch.equal(a["tokens"], TokenPipeline(cfg, 6, 10, seed=4,
                                                      device="cpu").batch_at(5)["tokens"])
    part = pipe.batch_at(5, lo=2, hi=4)                             # a host slice, alone
    assert part["tokens"].shape == (2, 11)
    assert torch.equal(part["tokens"], pipe.batch_at(5, lo=2, hi=4)["tokens"])
    assert int(a["tokens"].max()) < cfg.vocab_size and int(a["tokens"].min()) >= 0
    it = iter(pipe)
    assert torch.equal(next(it)["tokens"], pipe.batch_at(0)["tokens"])
    assert torch.equal(next(it)["tokens"], pipe.batch_at(1)["tokens"])
    assert pipe.state_dict(7) == {"seed": 3, "step": 7, "global_batch": 6, "seq_len": 10}
    per = TokenPipeline(cfg, 4, 12, seed=1, mode="periodic", device="cpu").batch_at(2)
    stride = 1 + 2 % 3
    assert bool(((per["tokens"][:, 1:] - per["tokens"][:, :-1]) % cfg.vocab_size
                 == stride).all())


@pytest.mark.parametrize("arch, mode", [("internlm2-1.8b", "uniform"),
                                        ("internlm2-1.8b", "periodic"),
                                        ("whisper-large-v3", "uniform"),
                                        ("llama-3.2-vision-90b", "uniform")])
def test_pipeline_replays_reference(arch, mode):
    """With the ``jax.random`` draws replayed, every batch — tokens, frames
    and image stubs, whole and as a host slice — is the reference's."""
    from repro.configs import get_config as j_get_config
    ref = JPipeline(j_get_config(arch, smoke=True), 8, 12, seed=5, mode=mode)
    port = TokenPipeline(t_get_config(arch, smoke=True), 8, 12, seed=5, mode=mode,
                         device="cpu", draws=JaxTokenDraws())
    for step, lo, hi in ((0, 0, None), (7, 0, None), (7, 3, 6)):
        a, b = ref.batch_at(step, lo=lo, hi=hi), port.batch_at(step, lo=lo, hi=hi)
        assert set(a) == set(b)
        for key in a:
            np.testing.assert_array_equal(np.asarray(a[key], np.float32),
                                          b[key].float().numpy())


# ----------------------------------------------------------------------
# the kNN-LM flow of examples/knn_lm.py
# ----------------------------------------------------------------------
def interpolate(p_lm, dist, gid, labels, vocab, lam=0.25, temp=1.0):
    """The example's mixture of the LM distribution and the neighbours'."""
    out = []
    for i in range(len(p_lm)):
        valid = gid[i] >= 0
        knn = np.zeros(vocab, np.float32)
        if valid.any():
            w = np.exp(-dist[i][valid] / temp)
            w = w / w.sum()
            for wj, g in zip(w, gid[i][valid]):
                knn[labels[g]] += wj
        out.append((1 - lam) * p_lm[i] + lam * knn)
    return np.stack(out)


def test_knn_lm_flow_matches_reference():
    jm, jp, tm, tp, _ = both_params("internlm2-1.8b", 0, fp32=False)
    cfg = jm.cfg
    jpipe = JPipeline(cfg, global_batch=32, seq_len=32, seed=0)
    tpipe = TokenPipeline(tm.cfg, global_batch=32, seq_len=32, seed=0,
                          device="cpu", draws=JaxTokenDraws())
    jfwd = jax.jit(lambda p, b: jm.forward(p, b, kv_chunk=32))

    # ---- datastore: (hidden-state proxy at t) -> token at t+1 -------------
    j_emb, t_emb, labels = [], [], []
    for step in range(2):
        jt = jpipe.batch_at(step)["tokens"][:, :-1]
        tt = tpipe.batch_at(step)["tokens"][:, :-1]
        np.testing.assert_array_equal(np.asarray(jt), tt.numpy())
        j_emb.append(np.asarray(jfwd(jp, {"tokens": jt})[..., :cfg.d_model][:, :-1]
                                .reshape(-1, cfg.d_model), np.float32))
        t_emb.append(tm(tp, {"tokens": tt}, kv_chunk=32)[..., :cfg.d_model][:, :-1]
                     .reshape(-1, cfg.d_model).float())
        labels.append(tt[:, 1:].reshape(-1).numpy())
    datastore, labels = np.concatenate(j_emb), np.concatenate(labels)
    assert rel_err(datastore, torch.cat(t_emb)) <= BF16_RTOL

    # ---- the index, built from the reference's datastore and draws --------
    ccfg = dict(series_len=cfg.d_model, paa_segments=16, num_pivots=48, prefix_len=6,
                capacity=256, sample_frac=0.25, max_centroids=24, k=16,
                candidate_groups=4, adaptive_factor=4)
    key = jax.random.PRNGKey(1)
    j_index = j_build_index(key, jnp.asarray(datastore), JConfig(**ccfg))
    sample_idx, pivot_idx = reference_draws(key, len(datastore), TConfig(**ccfg))
    t_index = t_build_index(torch.from_numpy(datastore), TConfig(**ccfg), device="cpu",
                            sample_idx=sample_idx, pivot_idx=pivot_idx)
    assert t_index.store.num_partitions == j_index.forest.num_partitions

    # ---- interpolated next-token prediction -------------------------------
    ctx = jpipe.batch_at(99)["tokens"][:4, :16]
    j_logits = jfwd(jp, {"tokens": ctx})
    t_logits = tm(tp, {"tokens": torch.from_numpy(np.array(ctx))}, kv_chunk=32)
    assert rel_err(j_logits, t_logits) <= BF16_RTOL
    q = np.asarray(j_logits[:, -1, :cfg.d_model], np.float32)
    j_d, j_g, _ = j_knn_query(j_index, jnp.asarray(q), 16, variant="adaptive")
    t_d, t_g, _ = t_knn_query(t_index, torch.from_numpy(q), 16, variant="adaptive")
    j_d, j_g = np.asarray(j_d), np.asarray(j_g)
    np.testing.assert_array_equal(t_g.numpy(), j_g)
    tol = 1e-5 * ((q * q).sum(-1, keepdims=True) + (datastore ** 2).sum(-1).max())
    assert (np.abs(t_d.numpy().astype(np.float64) ** 2 - j_d.astype(np.float64) ** 2)
            <= tol).all()
    j_mix = interpolate(np.asarray(jax.nn.softmax(j_logits[:, -1].astype(jnp.float32))),
                        j_d, j_g, labels, cfg.vocab_size)
    t_mix = interpolate(torch.softmax(t_logits[:, -1].float(), -1).numpy(),
                        t_d.numpy(), t_g.numpy(), labels, cfg.vocab_size)
    assert (j_g >= 0).sum() > 0
    assert np.abs(t_mix - j_mix).max() <= MIX_ATOL
    assert np.allclose(t_mix.sum(-1), 1.0, atol=1e-3)
