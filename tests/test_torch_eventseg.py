"""The port's event segmentation against the JAX package on the CPU.

``brainiak_tpu_torch.eventseg`` and ``ops.masked`` on ``device="cpu"``,
in float64 (the harness turns the JAX package's x64 on): the fitted
``segments_``, ``event_pat_`` and ``ll_`` within 1e-8 of the JAX
package's, the fused forward-backward against the port's two-loop
reference and the JAX package's, and a preempted, resumed fit bit for
bit the unbroken one.  The first annealing step's log-likelihood is the
exception the JAX package's own tests make: its mean pattern is the
z-scored data's row means (about 1e-17), whose z-score over voxels is
rounding noise, so ``ll_[0]`` is held to 5e-3 (every event pattern is
that same noise, so the segmentation, and every later step, does not
depend on it).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.special import comb

from brainiak_tpu.eventseg import event as jev
from brainiak_tpu.ops.masked import masked_log as jmasked_log
from brainiak_tpu_torch.eventseg import EventSegment
from brainiak_tpu_torch.eventseg import event as tev
from brainiak_tpu_torch.funcalign.srm import NotFittedError
from brainiak_tpu_torch.ops.masked import masked_log

TOL = 1e-8
LL0_ATOL = 5e-3


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def ES(*args, **kwargs):
    return EventSegment(*args, device="cpu", **kwargs)


def _planted(seed, n_vox, t, k, noise=0.3):
    rng = np.random.RandomState(seed)
    ev = np.linspace(0, t, k + 1).astype(int)
    pats = rng.rand(n_vox, k)
    d = np.zeros((t, n_vox))
    for e in range(k):
        d[ev[e]:ev[e + 1]] = pats[:, e] + noise * rng.rand(
            ev[e + 1] - ev[e], n_vox)
    return d


def _same_fit(port, ref):
    assert port.ll_.shape == ref.ll_.shape
    np.testing.assert_allclose(port.ll_[0], ref.ll_[0], atol=LL0_ATOL)
    np.testing.assert_allclose(port.ll_[1:], ref.ll_[1:], atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(port.event_pat_, ref.event_pat_, atol=TOL)
    assert len(port.segments_) == len(ref.segments_)
    for a, b in zip(port.segments_, ref.segments_):
        np.testing.assert_allclose(a, b, atol=TOL)
    assert np.isclose(port.event_var_, ref.event_var_)


def test_masked_log_matches_jax():
    x = np.array([[2.0, 0.0, -1.0], [1e-300, np.inf, 0.5]])
    got = masked_log(torch.as_tensor(x)).numpy()
    assert np.array_equal(got, np.asarray(jmasked_log(jnp.asarray(x))))
    assert np.array_equal(masked_log(np.zeros(3)).numpy(),
                          np.full(3, -np.inf))


def test_fit_shapes_and_jax_values():
    K, V, T = 5, 3, 10
    rng = np.random.RandomState(0)
    d = rng.rand(V, T).T
    es = ES(K, n_iter=2).fit(d)
    _same_fit(es, jev.EventSegment(K, n_iter=2).fit(d))
    assert es.segments_[0].shape == (T, K)
    assert np.allclose(np.sum(es.segments_[0], axis=1), 1.0)
    T2 = 15
    held_out = rng.rand(V, T2).T
    test_segments, test_ll = es.find_events(held_out)
    assert test_segments.shape == (T2, K)
    assert np.allclose(np.sum(test_segments, axis=1), 1.0)
    assert np.isfinite(test_ll)
    ref = jev.EventSegment(K)
    ref.set_event_patterns(es.event_pat_)
    want_seg, want_ll = ref.find_events(held_out, var=es.event_var_)
    np.testing.assert_allclose(test_segments, want_seg, atol=TOL)
    assert np.isclose(test_ll, want_ll, rtol=TOL)
    # scramble=True permutes the learned patterns with the host's
    # np.random (the reference's null-model control)
    np.random.seed(4)
    scr_segments, scr_ll = es.find_events(held_out, scramble=True)
    np.random.seed(4)
    perm = np.random.permutation(K)
    ref.set_event_patterns(es.event_pat_[:, perm])
    np.testing.assert_allclose(
        scr_segments, ref.find_events(held_out, var=es.event_var_)[0],
        atol=TOL)
    assert np.isfinite(scr_ll)
    with pytest.raises(ValueError):
        ES(K).model_prior(K - 1)
    with pytest.raises(ValueError):
        ES(K).set_event_patterns(np.zeros((V, K - 1)))
    with pytest.raises(ValueError):
        es.fit(np.full((4, 3), np.nan))
    with pytest.raises(ValueError, match="same number of voxels"):
        es.fit([rng.rand(6, 3), rng.rand(6, 4)])


def test_simple_boundary():
    es = ES(2)
    rng = np.random.RandomState(0)
    sample_data = np.array([[1, 1, 1, 0, 0, 0, 0],
                            [0, 0, 0, 1, 1, 1, 1]]) + rng.rand(2, 7) * 10
    es.fit(sample_data.T)
    events = np.argmax(es.segments_[0], axis=1)
    assert np.array_equal(events, [0, 0, 0, 1, 1, 1, 1])
    assert np.array_equal(es.predict(sample_data.T),
                          [0, 0, 0, 1, 1, 1, 1])
    _same_fit(es, jev.EventSegment(2).fit(sample_data.T))


def test_event_transfer():
    es = ES(2)
    sample_data = np.asarray([[1, 1, 1, 0, 0, 0, 0],
                              [0, 0, 0, 1, 1, 1, 1]], dtype=float)
    with pytest.raises(NotFittedError):
        es.find_events(sample_data.T)
    with pytest.raises(NotFittedError):
        es.find_events(sample_data.T, np.asarray([1, 1]))
    with pytest.raises(NotFittedError):
        es.predict(sample_data.T)
    es.set_event_patterns(np.asarray([[1, 0], [0, 1]], dtype=float))
    seg = es.find_events(sample_data.T, np.asarray([1.0, 1.0]))[0]
    assert np.array_equal(np.argmax(seg, axis=1), [0, 0, 0, 1, 1, 1, 1])


def test_weighted_var():
    es = ES(2)
    D = np.zeros((8, 4))
    for t in range(4):
        D[t, :] = (1 / np.sqrt(4 / 3)) * np.array([-1, -1, 1, 1])
    for t in range(4, 8):
        D[t, :] = (1 / np.sqrt(4 / 3)) * np.array([1, 1, -1, -1])
    mean_pat = D[[0, 4], :].T
    weights = np.zeros((8, 2))
    weights[:, 0] = [1, 1, 1, 1, 0, 0, 0, 0]
    weights[:, 1] = [0, 0, 0, 0, 1, 1, 1, 1]
    assert np.array_equal(
        es.calc_weighted_event_var(D, weights, mean_pat), [0, 0])
    weights[:, 0] = [1, 1, 1, 1, 0.5, 0.5, 0.5, 0.5]
    weights[:, 1] = [0.5, 0.5, 0.5, 0.5, 1, 1, 1, 1]
    true_var = (4 * 0.5 * 12) / (6 - 5 / 6) * np.ones(2) / 4
    assert np.allclose(
        es.calc_weighted_event_var(D, weights, mean_pat), true_var)


def test_sym():
    es = ES(4)
    evpat = np.repeat(np.arange(10).reshape(-1, 1), 4, axis=1)
    es.set_event_patterns(evpat.astype(float))
    D = np.repeat(np.arange(10).reshape(1, -1), 20, axis=0).astype(float)
    ev = es.find_events(D, var=1)[0]
    assert np.allclose(ev[:, :2], np.fliplr(np.flipud(ev[:, 2:])))


def test_chains():
    es = ES(5, event_chains=np.array(['A', 'A', 'B', 'B', 'B']))
    sample_data = np.array([[0, 0, 0], [1, 1, 1]], dtype=float)
    with pytest.raises(RuntimeError):
        es.fit(sample_data.T)
    es.set_event_patterns(np.array([[1, 1, 0, 0, 0],
                                    [0, 0, 1, 1, 1]], dtype=float))
    seg = es.find_events(sample_data.T, 0.1)[0]
    ev = np.nonzero(seg > 0.99)[1]
    assert np.array_equal(ev, [2, 3, 4])


def test_prior():
    K, T = 10, 100
    es = ES(K)
    mp, ll = es.model_prior(T)
    p_bound = np.zeros((T, K - 1))
    norm = comb(T - 1, K - 1)
    for t in range(T - 1):
        for k in range(K - 1):
            p_bound[t + 1, k] = comb(t, k) * comb(T - t - 2, K - k - 2) \
                / norm
    p_bound = np.cumsum(p_bound, axis=0)
    mp_gt = np.zeros((T, K))
    for k in range(K):
        if k == 0:
            mp_gt[:, k] = 1 - p_bound[:, 0]
        elif k == K - 1:
            mp_gt[:, k] = p_bound[:, k - 1]
        else:
            mp_gt[:, k] = p_bound[:, k - 1] - p_bound[:, k]
    assert np.allclose(mp, mp_gt)
    want, want_ll = jev.EventSegment(K).model_prior(T)
    np.testing.assert_allclose(mp, want, atol=TOL)
    assert np.isclose(ll, want_ll, rtol=TOL, atol=TOL)


def test_split_merge():
    ev = np.array(
        [0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3,
         3, 3, 3, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4])
    rng = np.random.RandomState(0)
    ev_pat = rng.rand(5, 10)
    D = np.zeros((len(ev), 10))
    for t in range(len(ev)):
        D[t, :] = ev_pat[ev[t], :] + 0.1 * rng.rand(10)
    hmm_sm = ES(5, split_merge=True, split_merge_proposals=2)
    hmm_sm.fit(D)
    assert np.array_equal(np.argmax(hmm_sm.segments_[0], axis=1), ev)
    # the first 12 annealing steps, proposals included, are the JAX
    # package's
    kw = dict(split_merge=True, split_merge_proposals=2, n_iter=12)
    _same_fit(ES(5, **kw).fit(D), jev.EventSegment(5, **kw).fit(D))
    # K=2: every (merge, split) pair collides with the merge position,
    # so the proposal list is empty and the step falls through
    rng2 = np.random.RandomState(1)
    pat2 = rng2.rand(2, 6)
    ev2 = np.array([0] * 8 + [1] * 8)
    D2 = pat2[ev2] + 0.05 * rng2.rand(16, 6)
    hmm2 = ES(2, split_merge=True)
    hmm2.fit(D2)
    assert np.array_equal(np.argmax(hmm2.segments_[0], axis=1), ev2)


def test_subevent_patterns_degenerate_event():
    es = ES(2)
    t, v = 6, 4
    sp = np.zeros((t, 2))
    sp[0, 0] = 1.0
    sp[1:, 1] = 1.0 / (t - 1)
    X = np.arange(v * t, dtype=float).reshape(v, t)
    first, second, pairs = es._subevent_patterns([X], [sp])
    assert np.all(np.isfinite(first)) and np.all(np.isfinite(second))
    assert np.allclose(first[:, 0], 0.0)
    assert np.all(np.isfinite(pairs))


def test_sym_ll():
    ev = np.array([0, 0, 0, 1, 1, 1, 1, 1, 1, 2, 2])
    rng = np.random.RandomState(0)
    ev_pat = rng.rand(3, 10)
    D_forward = np.zeros((len(ev), 10))
    for t in range(len(ev)):
        D_forward[t, :] = ev_pat[ev[t], :] + 0.1 * rng.rand(10)
    D_backward = np.flip(D_forward, axis=0)
    hmm_f = ES(3)
    hmm_f.set_event_patterns(ev_pat.T)
    _, ll_forward = hmm_f.find_events(D_forward, var=1)
    hmm_b = ES(3)
    hmm_b.set_event_patterns(np.flip(ev_pat.T, axis=1))
    _, ll_backward = hmm_b.find_events(D_backward, var=1)
    assert np.isclose(ll_forward, ll_backward)


def test_multiple_datasets_fit():
    rng = np.random.RandomState(1)
    base = np.array([[1, 1, 1, 0, 0, 0, 0], [0, 0, 0, 1, 1, 1, 1]],
                    dtype=float)
    X = [(base + rng.rand(2, 7)).T, (base + rng.rand(2, 7)).T]
    es = ES(2).fit(X)
    assert len(es.segments_) == 2
    assert es.ll_.shape[1] == 2
    for seg in es.segments_:
        assert np.array_equal(np.argmax(seg, axis=1),
                              [0, 0, 0, 1, 1, 1, 1])
    _same_fit(es, jev.EventSegment(2).fit(X))


def test_fused_fit_matches_host_loop_and_jax():
    """The device loop reproduces the host-driven annealing loop
    iterate for iterate, and both the JAX package's fit (float64)."""
    d = _planted(7, 12, 40, 4)
    fused = ES(4, n_iter=60).fit(d)
    host = ES(4, n_iter=60)
    host._force_host_loop = True
    host.fit(d)
    assert fused.ll_.shape == host.ll_.shape
    np.testing.assert_allclose(fused.ll_[0], host.ll_[0], atol=LL0_ATOL)
    np.testing.assert_allclose(fused.ll_[1:], host.ll_[1:], rtol=1e-10)
    np.testing.assert_allclose(fused.event_pat_, host.event_pat_,
                               rtol=1e-10)
    assert np.isclose(fused.event_var_, host.event_var_)
    np.testing.assert_allclose(fused.segments_[0], host.segments_[0],
                               atol=1e-10)
    _same_fit(fused, jev.EventSegment(4, n_iter=60).fit(d))


def test_float32_fit_runs_float32():
    d = _planted(8, 10, 30, 3).astype(np.float32)
    es = ES(3, n_iter=20).fit(d)
    assert es.event_pat_.dtype == np.float32
    assert es.segments_[0].dtype == np.float32
    ref = ES(3, n_iter=20).fit(d.astype(np.float64))
    assert es.ll_.shape == ref.ll_.shape
    np.testing.assert_allclose(es.ll_[1:], ref.ll_[1:], rtol=1e-4)


def test_checkpointed_fit_resumes_bit_for_bit(tmp_path):
    """A fit preempted after its second checkpoint resumes to the
    unbroken fit's iterates, bit for bit (the same steps run in the
    same order; the state crosses the checkpoint as host arrays)."""
    from brainiak_tpu_torch.resilience import faults

    d = _planted(9, 10, 36, 4)
    whole = ES(4, n_iter=40).fit(d)
    ckpt = os.path.join(str(tmp_path), "ckpt")
    with pytest.raises(faults.PreemptionError):
        with faults.inject("preempt", at_step=6):
            ES(4, n_iter=40).fit(d, checkpoint_dir=ckpt,
                                 checkpoint_every=3)
    resumed = ES(4, n_iter=40).fit(d, checkpoint_dir=ckpt,
                                   checkpoint_every=3)
    assert np.array_equal(resumed.ll_, whole.ll_)
    assert np.array_equal(resumed.event_pat_, whole.event_pat_)
    assert np.array_equal(resumed.segments_[0], whole.segments_[0])
    assert resumed.event_var_ == whole.event_var_


def test_estimator_params():
    es = ES(3, n_iter=7)
    params = es.get_params()
    assert params["n_events"] == 3 and params["n_iter"] == 7
    assert params["device"] == "cpu"
    es.set_params(n_iter=9)
    assert es.n_iter == 9
    with pytest.raises(ValueError):
        es.set_params(bogus=1)


def _fb_args(t, k, seed=0):
    rng = np.random.RandomState(seed)
    es = ES(k)
    log_P, log_p_start, log_p_end = es._build_transitions(t)
    lp = np.hstack([rng.randn(t, k), np.full((t, 1), -np.inf)])
    return lp, log_P, log_p_start, log_p_end


def _fb_compare(args, rows=slice(None)):
    """(max diff treating mutual -inf/NaN as equal, mask mismatch,
    ll agreement) of the fused and the two-loop forward-backward, and
    the same of the fused one against the JAX package's, over
    ``rows`` of the gammas."""
    t_args = [torch.as_tensor(a) for a in args]
    g1, l1 = tev._forward_backward_core(*t_args)
    g2, l2 = tev._forward_backward_reference(*t_args)
    g3, l3 = jev._fb_program()(*[jnp.asarray(a) for a in args])
    out = []
    for b, lb in ((g2.numpy()[rows], float(l2)),
                  (np.asarray(g3)[rows], float(l3))):
        a = g1.numpy()[rows]
        mismatch = (np.any(np.isneginf(a) != np.isneginf(b))
                    or np.any(np.isnan(a) != np.isnan(b)))
        same = np.isneginf(a) & np.isneginf(b)
        with np.errstate(invalid="ignore"):
            d = np.abs(a - b)
        d[same | np.isnan(a)] = 0.0
        ll_ok = (float(l1) == lb or np.isclose(float(l1), lb, rtol=1e-10)
                 or (np.isnan(float(l1)) and np.isnan(lb)))
        out.append((float(np.max(d)), bool(mismatch), ll_ok))
    return out


@pytest.mark.parametrize("t,k", [(40, 5), (7, 2), (200, 16)])
def test_fused_forward_backward_matches_two_loop_reference(t, k):
    for d, mismatch, ll_ok in _fb_compare(_fb_args(t, k)):
        assert d < 1e-9 and not mismatch and ll_ok


def test_fused_forward_backward_masked_log_edges():
    """Masked-log edge cases.  An event column entirely -inf (an
    impossible state): identical gammas, -inf masks and lls on the
    fused path, the two-loop one and the JAX package's.  A row of
    -1e30 (a spike) absorbs the O(1) log-alphas of that timepoint in
    every form; outside that row all three agree, and so do the lls
    (-1e30).  In it the two-loop forms (the JAX package's among them)
    also lose the row's normalization (log-gamma 0 for every state),
    while the fused form scales each row by its own maximum: its row
    is a distribution, with the same -inf mask."""
    lp, *rest = _fb_args(30, 4)
    impossible = np.where(np.arange(5) == 1, -np.inf, lp)
    for d, mismatch, ll_ok in _fb_compare([impossible] + rest):
        assert d < 1e-9 and not mismatch and ll_ok
    spike = np.vstack([lp[:3], np.full((1, 5), -1e30), lp[4:]])
    keep = np.arange(30) != 3
    for d, mismatch, ll_ok in _fb_compare([spike] + rest, rows=keep):
        assert d < 1e-9 and not mismatch and ll_ok
    g, ll = tev._forward_backward_core(
        *[torch.as_tensor(a) for a in [spike] + rest])
    ref = np.asarray(jev._fb_program()(
        *[jnp.asarray(a) for a in [spike] + rest])[0])
    assert float(ll) == -1e30
    assert np.array_equal(np.isneginf(g.numpy()[3]), np.isneginf(ref[3]))
    assert np.isclose(np.exp(g.numpy()[3]).sum(), 1.0, rtol=1e-12)


def test_forward_step_matches_jax():
    rng = np.random.RandomState(3)
    es = ES(4)
    log_P = es._build_transitions(20)[0]
    prev = rng.randn(5)
    prev = prev - np.log(np.sum(np.exp(prev)))
    obs = np.append(rng.randn(4), -np.inf)
    a, s = tev.forward_step(torch.as_tensor(prev), torch.as_tensor(obs),
                            torch.as_tensor(log_P))
    ja, js = jev.forward_step(jnp.asarray(prev), jnp.asarray(obs),
                              jnp.asarray(log_P))
    np.testing.assert_allclose(a.numpy(), np.asarray(ja), atol=1e-12)
    assert np.isclose(float(s), float(js), rtol=1e-12)
    # batched rows step as single rows do
    both = tev.forward_step(torch.as_tensor(np.stack([prev, prev])),
                            torch.as_tensor(np.stack([obs, obs])),
                            torch.as_tensor(log_P))
    assert np.array_equal(both[0].numpy()[1], a.numpy())


def test_device_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        EventSegment(2).fit(np.random.RandomState(0).rand(7, 2))
