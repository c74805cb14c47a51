"""HMM event segmentation on a CUDA device.

PyTorch counterpart of ``brainiak_tpu/eventseg/event.py``.  The model:
fMRI timepoints are generated by a left-to-right chain of ``n_events``
Gaussian event states (plus a sink state), transition probability
``(n_events-1)/T``; fitting anneals the event variance
(``4*0.98**(step-1)``) while alternating mean-pattern updates with
forward-backward E-steps, stopping when the log-likelihood decreases.

The JAX package's scans and ``lax.while_loop`` are Python loops over
tensors on ``device`` here, so their speed is their launches: the
fused forward-backward runs both recursions in ONE loop over time (a
forward row and a backward row a step, every subject of a fit batched
beside them; the two-loop :func:`_forward_backward_reference` is its
plain version), and the annealed EM is a loop over steps whose accept
/ stop decision is made on the device with ``torch.where`` and read
once a step (the loop's only host sync).  The observation
log-probability is a matmul decomposition.  A fit runs in its data's
dtype (float32 data: a float32 fit, transitions and variances
included).
"""

import copy
import logging

import numpy as np
import torch
from scipy import stats

from ..device import resolve_device
from ..funcalign.srm import NotFittedError, _Estimator
from ..obs import spans as obs_spans
from ..ops.masked import masked_log
from ..resilience.guards import (_host, array_digest, check_state,
                                 run_resilient_loop)

__all__ = ["EventSegment", "forward_step"]

logger = logging.getLogger(__name__)


def _lse(x, dim, keepdim=False):
    """``logsumexp`` over ``dim``: shifted by the maximum (clamped to
    the dtype's lowest finite value, so a slice of all -inf gives -inf,
    as the JAX op does)."""
    m = torch.clamp(x.amax(dim=dim, keepdim=True),
                    min=torch.finfo(x.dtype).min)
    out = (x - m).exp().sum(dim=dim, keepdim=True).log() + m
    return out if keepdim else out.squeeze(dim)


def _advance(rows, obs, P):
    """The recursion's core, one step of log rows over a chain:
    ``log(exp(rows - m) @ P) + obs`` and the rows' maxima ``m``, which
    the result leaves out (the logsumexp over ``i`` of ``rows_i +
    log P_ij`` is this plus ``m``; a state more than the dtype's
    exponent range below ``m`` drops out, as its probability does).
    A row of all -inf gives NaN, as the logsumexp form's scaling
    does."""
    m = rows.amax(dim=-1, keepdim=True)
    u = ((rows - m).exp()[..., None, :] @ P)[..., 0, :]
    return torch.log(u) + obs, m


def _scaled(w):
    """(log_softmax(w), logsumexp(w)) of rows ``w``: the largest entry
    of ``log_softmax`` is minus the log normalizer exactly."""
    alpha = torch.log_softmax(w, dim=-1)
    return alpha, w.amax(dim=-1) - alpha.amax(dim=-1)


def forward_step(prev_alpha, obs, log_P, P=None):
    """One scaled HMM forward-recursion step over a (K+1)-state
    chain: advances the scaled log-alpha row by one observation.

    The single source of the forward recursion: its core
    (:func:`_advance`, the logsumexp over the chain as a product after
    a shift by the row's maximum) is what the batch loop of the
    forward-backward (:func:`_forward_backward_core`) steps through,
    for its backward rows too (a backward step is a forward step on
    the transposed chain).

    Parameters
    ----------
    prev_alpha : [..., K+1] scaled log-alpha rows at t-1
        (``logsumexp(prev_alpha) == 0``).
    obs : [..., K+1] observation log-probability rows at t
        (sink column ``-inf``).
    log_P : [..., K+1, K+1] transition log-probabilities.
    P : ``exp(log_P)``, when the caller has it.

    Returns
    -------
    (scaled_alpha [..., K+1], log_scale [...]): the scaled rows at t
    and the log normalizers they shed (the per-TR log-likelihood
    increments).
    """
    w, m = _advance(prev_alpha, obs, log_P.exp() if P is None else P)
    alpha, scale = _scaled(w)
    return alpha, scale + m[..., 0]


def _log_likelihood(log_alpha, log_scale, log_p_end):
    t = log_scale.shape[-1]
    return log_scale[..., :t - 1].sum(dim=-1) + _lse(
        log_alpha[..., -1, :] + log_scale[..., -1:] + log_p_end, dim=-1)


def _forward_backward_core(logprob, log_P, log_p_start, log_p_end):
    """Forward-backward over a (K+1)-state chain (incl. the sink
    state), the fused form: ONE loop over time runs both recursions.

    logprob: [..., T, K+1] observation log-probs (sink column -inf).
    Returns (log_gamma [..., T, K+1], ll [...]).

    Step ``i`` advances two rows through the forward recursion's core
    (:func:`_advance`) at once: alpha at ``i`` (the chain, then the
    observation at ``i``) and beta at ``T-1-i`` (the observation at
    ``T-i``, then the transposed chain).  A step only scales its rows
    (``log_softmax``) for the next; the unscaled rows are kept and the
    forward scales, the log-likelihood's, come from them in one batched
    logsumexp after the loop.  The beta rows are scaled by their own
    normalizers rather than the forward ones, a constant a timepoint
    that the normalized gamma does not see.  So the loop runs ``T-1``
    steps of eight launches where the two-loop form
    (:func:`_forward_backward_reference`) runs ``2 (T-1)`` steps of
    about twenty.
    """
    t = logprob.shape[-2]
    Ps = torch.stack([log_P, log_P.T]).exp()
    zeros = torch.zeros_like(logprob[..., 1:, :])
    # before the product: the backward row adds the next observation;
    # after it: the forward row adds its own
    pre = torch.stack([zeros, logprob.flip(-2)[..., :-1, :]],
                      dim=-2).unbind(-3)
    post = torch.stack([logprob[..., 1:, :], zeros], dim=-2).unbind(-3)
    alpha0, scale0 = _scaled(log_p_start + logprob[..., 0, :])
    beta_last = log_p_end.expand_as(alpha0)
    rows = torch.stack([alpha0, beta_last], dim=-2)
    ws, ms = [], []
    for i in range(t - 1):
        w, m = _advance(rows + pre[i], post[i], Ps)
        rows = torch.log_softmax(w, dim=-1)
        ws.append(w)
        ms.append(m)
    log_alpha, log_beta = alpha0[..., None, :], beta_last[..., None, :]
    log_scale = scale0[..., None]
    if ws:
        w, m = torch.stack(ws, dim=-3), torch.stack(ms, dim=-3)
        alpha, scale = _scaled(w[..., 0, :])
        log_alpha = torch.cat([log_alpha, alpha], dim=-2)
        log_scale = torch.cat([log_scale, scale + m[..., 0, 0]], dim=-1)
        log_beta = torch.cat([torch.log_softmax(w[..., 1, :], dim=-1)
                              .flip(-2), log_beta], dim=-2)
    log_gamma = torch.log_softmax(log_alpha + log_beta, dim=-1)
    return log_gamma, _log_likelihood(log_alpha, log_scale, log_p_end)


def _lse_step(prev_alpha, obs, log_P):
    """The forward step as the JAX package writes it: two
    logsumexps (the reference's own, independent of
    :func:`forward_step`)."""
    alpha = _lse(prev_alpha[..., :, None] + log_P, dim=-2) + obs
    scale = _lse(alpha, dim=-1)
    return alpha - scale[..., None], scale


def _forward_backward_reference(logprob, log_P, log_p_start, log_p_end):
    """The two-loop formulation of the JAX package's reference: a
    forward loop, then a backward loop on the forward scales, the betas
    stacked between them and gamma a separate full-array
    normalization, every logsumexp a max-shifted reduction.  The plain
    version the fused path is held to."""
    t = logprob.shape[-2]
    rows = logprob.unbind(-2)
    alpha = log_p_start + rows[0]
    scale = _lse(alpha, dim=-1)
    alphas, scales = [alpha - scale[..., None]], [scale]
    for obs in rows[1:]:
        alpha, scale = _lse_step(alphas[-1], obs, log_P)
        alphas.append(alpha)
        scales.append(scale)
    log_alpha = torch.stack(alphas, dim=-2)
    log_scale = torch.stack(scales, dim=-1)
    beta = log_p_end - log_scale[..., -1:]
    betas = [beta]
    for i in range(t - 2, -1, -1):
        w = beta + rows[i + 1]
        beta = _lse(w[..., None, :] + log_P, dim=-1) - \
            scales[i][..., None]
        betas.append(beta)
    log_beta = torch.stack(betas[::-1], dim=-2)
    log_gamma = log_alpha + log_beta
    log_gamma = log_gamma - _lse(log_gamma, dim=-1, keepdim=True)
    return log_gamma, _log_likelihood(log_alpha, log_scale, log_p_end)


def _with_sink(lp):
    """[..., T, K] log-probs with the sink state's -inf column."""
    sink = torch.full(lp.shape[:-1] + (1,), -torch.inf, dtype=lp.dtype,
                      device=lp.device)
    return torch.cat([lp, sink], dim=-1)


def _logprob_obs_core(data, mean_pat, var):
    """Observation log-probability of each timepoint under each event
    Gaussian, measured on spatially z-scored data (Pearson geometry).

    data: [..., V, T]; mean_pat: [..., V, K]; var: [K] -> [..., T, K]
    (leading dimensions broadcast: subjects, or candidate patterns).
    """
    n_vox = data.shape[-2]
    data_z = (data - data.mean(dim=-2, keepdim=True)) / data.std(
        dim=-2, keepdim=True, correction=1)
    mp_z = (mean_pat - mean_pat.mean(dim=-2, keepdim=True)) / \
        mean_pat.std(dim=-2, keepdim=True, correction=1)
    # ||x - m||^2 = ||x||^2 - 2 x.m + ||m||^2, batched via matmul
    sq = ((data_z ** 2).sum(dim=-2)[..., :, None]
          - 2.0 * data_z.transpose(-1, -2) @ mp_z
          + (mp_z ** 2).sum(dim=-2)[..., None, :])
    logprob = -0.5 * n_vox * torch.log(2 * np.pi * var) \
        - 0.5 * sq / var
    return logprob / n_vox


def _segment_candidates_core(data, cand_pats, var, log_P, log_p_start,
                             log_p_end):
    """Forward-backward over a batch of candidate event-pattern sets.

    data: [V, T]; cand_pats: [C, V, K]; var: [K].
    Returns (log_gamma [C, T, K+1], ll [C]): all C candidate
    segmentations in one batched loop.
    """
    lp = _with_sink(_logprob_obs_core(data, cand_pats, var))
    return _forward_backward_core(lp, log_P, log_p_start, log_p_end)


_FIT_STATE_KEYS = ("step", "done", "lg", "ll_hist", "best_ll",
                   "best_lg", "best_pat", "best_var")


def _fit_core_init(x, var_schedule):
    """Initial annealed-EM state tuple for :func:`_fit_core_chunk`
    (fields :data:`_FIT_STATE_KEYS`; step an int, done a bool)."""
    n_train, n_vox, t = x.shape
    n_iter, k = var_schedule.shape
    opts = dict(dtype=x.dtype, device=x.device)
    return (0, False,
            torch.zeros((n_train, t, k), **opts),
            torch.full((n_iter, n_train), torch.nan, **opts),
            torch.tensor(-torch.inf, **opts),
            torch.zeros((n_train, t, k), **opts),
            torch.zeros((n_vox, k), **opts),
            var_schedule[0].clone())


def _em_step(x, lg, var, log_P, log_p_start, log_p_end):
    """One annealed-EM step of every subject: the mean pattern from
    the current segmentations, then the batched forward-backward.
    Returns (new_lg [S, T, K], lls [S], mean_pat [V, K])."""
    seg = torch.exp(lg)
    seg = seg / seg.sum(dim=1, keepdim=True)  # over T
    mean_pat = torch.einsum('svt,stk->svk', x, seg).mean(dim=0)
    lp = _with_sink(_logprob_obs_core(x, mean_pat, var))
    lg_full, lls = _forward_backward_core(lp, log_P, log_p_start,
                                          log_p_end)
    return lg_full[..., :-1], lls, mean_pat


def _fit_core_chunk(x, var_schedule, log_P, log_p_start, log_p_end,
                    state, step_limit):
    """Annealed EM from explicit ``state`` up to ``step_limit``: the
    checkpointable unit of preemption-safe fits.

    x : [S, V, T] spatially comparable (equal-shape), z-scored datasets
    var_schedule : [n_iter, K] per-step event variances
    state : tuple as produced by :func:`_fit_core_init`

    Each step's accept rule (``mean_ll >= best_ll``) and best-iterate
    snapshot are ``torch.where`` on the device; ``done`` is read once
    a step to end the loop.
    """
    n_iter = var_schedule.shape[0]
    step, done, lg, ll_hist, best_ll, best_lg, best_pat, best_var = state
    while step < min(step_limit, n_iter) and not done:
        var = var_schedule[step]
        new_lg, lls, mean_pat = _em_step(x, lg, var, log_P, log_p_start,
                                         log_p_end)
        mean_ll = lls.mean()
        # the host loop breaks BEFORE storing a decreasing-LL iterate
        accept = mean_ll >= best_ll
        ll_hist = ll_hist.clone()
        ll_hist[step] = torch.where(accept, lls, ll_hist[step])
        lg = torch.where(accept, new_lg, lg)
        best_lg = torch.where(accept, new_lg, best_lg)
        best_pat = torch.where(accept, mean_pat, best_pat)
        best_var = torch.where(accept, var, best_var)
        best_ll = torch.where(accept, mean_ll, best_ll)
        step += 1
        done = not bool(accept)
    return (step, done, lg, ll_hist, best_ll, best_lg, best_pat,
            best_var)


def _fit_core(x, var_schedule, log_P, log_p_start, log_p_end):
    """The whole annealed EM fit (no checkpointing).

    Returns (best_lg [S, T, K], best_pat [V, K], best_var [K],
             ll_hist [n_iter, S] (NaN rows beyond the accepted steps),
             n_accepted).
    """
    n_iter = var_schedule.shape[0]
    (step, done, _, ll_hist, _, best_lg, best_pat,
     best_var) = _fit_core_chunk(
        x, var_schedule, log_P, log_p_start, log_p_end,
        _fit_core_init(x, var_schedule), n_iter)
    return best_lg, best_pat, best_var, ll_hist, step - int(done)


def _column_corr(a, b):
    """Pearson correlation between corresponding columns of ``a``/``b``.

    Constant columns yield NaN (sorted last by argsort, so they are
    never preferred as proposals)."""
    with np.errstate(invalid="ignore", divide="ignore"):
        az = (a - a.mean(axis=0)) / a.std(axis=0)
        bz = (b - b.mean(axis=0)) / b.std(axis=0)
        return np.mean(az * bz, axis=0)


def _check_array(a):
    """A finite 2-D numeric array (the checks of sklearn's
    ``check_array``, which the port does not import)."""
    a = np.asarray(a)
    if a.ndim != 2:
        raise ValueError("Expected 2D array, got {}D array instead"
                         .format(a.ndim))
    if a.dtype.kind not in "biuf":
        a = a.astype(np.float64)
    if a.dtype.kind == "f" and not np.isfinite(a).all():
        raise ValueError("Input contains NaN, infinity or a value too "
                         "large for dtype({!r}).".format(a.dtype.name))
    return a


class EventSegment(_Estimator):
    """Event segmentation of continuous fMRI data.

    Parameters
    ----------
    n_events : int
    step_var : callable step -> variance (default ``4*0.98**(step-1)``)
    n_iter : int, max annealing steps (default 500)
    event_chains : ndarray of per-event chain labels (default: one chain)
    split_merge : bool, propose merge/split moves during fit
    split_merge_proposals : int, proposals per step
    device : ``"cuda"`` (default; raises without a card) or ``"cpu"``
    """

    _param_names = ("n_events", "step_var", "n_iter", "event_chains",
                    "split_merge", "split_merge_proposals", "device")

    def _default_var_schedule(step):
        return 4 * (0.98 ** (step - 1))

    def __init__(self, n_events=2, step_var=_default_var_schedule,
                 n_iter=500, event_chains=None, split_merge=False,
                 split_merge_proposals=1, device="cuda"):
        self.n_events = n_events
        self.step_var = step_var
        self.n_iter = n_iter
        self.split_merge = split_merge
        self.split_merge_proposals = split_merge_proposals
        self.device = device
        if event_chains is None:
            self.event_chains = np.zeros(n_events)
        else:
            self.event_chains = event_chains

    def _tensor(self, a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=dtype),
                               device=resolve_device(self.device))

    # -- transition structure --------------------------------------------
    def _build_transitions(self, t):
        """Left-to-right chain(s) + sink state.

        Sets p_start, p_end, P and returns their logs as float64 numpy
        arrays."""
        k = self.n_events
        self.p_start = np.zeros(k + 1)
        self.p_end = np.zeros(k + 1)
        self.P = np.zeros((k + 1, k + 1))
        label_ind = np.unique(self.event_chains, return_inverse=True)[1]
        n_chains = int(np.max(label_ind)) + 1
        for c in range(n_chains):
            chain_ind = np.nonzero(label_ind == c)[0]
            self.p_start[chain_ind[0]] = 1 / n_chains
            self.p_end[chain_ind[-1]] = 1 / n_chains
            p_trans = (len(chain_ind) - 1) / t
            if p_trans >= 1:
                raise ValueError('Too few timepoints')
            for i in range(len(chain_ind)):
                self.P[chain_ind[i], chain_ind[i]] = 1 - p_trans
                if i < len(chain_ind) - 1:
                    self.P[chain_ind[i], chain_ind[i + 1]] = p_trans
                else:
                    self.P[chain_ind[i], -1] = p_trans
        self.P[-1, -1] = 1
        return tuple(masked_log(m).numpy()
                     for m in (self.P, self.p_start, self.p_end))

    def _forward_backward(self, logprob):
        """Run the fused forward-backward on the device; returns
        (log_gamma [T, K], ll)."""
        t = logprob.shape[0]
        log_P, log_p_start, log_p_end = self._build_transitions(t)
        dtype = np.result_type(logprob.dtype, log_P.dtype)
        logprob_ext = np.hstack([logprob, np.full((t, 1), -np.inf)])
        with obs_spans.span("eventseg.forward_backward",
                            attrs={"n_trs": int(t),
                                   "n_events": int(self.n_events)}):
            log_gamma, ll = _forward_backward_core(
                *(self._tensor(a, dtype) for a in
                  (logprob_ext, log_P, log_p_start, log_p_end)))
            log_gamma = _host(log_gamma)
            ll = float(ll)
        return log_gamma[:, :-1], ll

    def _logprob_obs(self, data, mean_pat, var):
        if not isinstance(var, np.ndarray):
            var = var * np.ones(self.n_events)
        dtype = np.result_type(np.asarray(data).dtype, mean_pat.dtype,
                               var.dtype, np.float32)
        return _host(_logprob_obs_core(
            *(self._tensor(a, dtype) for a in (data, mean_pat, var))))

    # -- fitting ---------------------------------------------------------
    def _fit_validate(self, X):
        if len(np.unique(self.event_chains)) > 1:
            raise RuntimeError("Cannot fit chains, use set_event_patterns")
        X = copy.deepcopy(X)
        if not isinstance(X, list):
            X = [X]
        for i in range(len(X)):
            X[i] = _check_array(X[i]).T
        n_dim = X[0].shape[0]
        if any(x.shape[0] != n_dim for x in X):
            raise ValueError("every dataset must have the same number "
                             "of voxels")
        for i in range(len(X)):
            X[i] = stats.zscore(X[i], axis=1, ddof=1)
        return X

    def fit(self, X, y=None, checkpoint_dir=None, checkpoint_every=5):
        """Anneal event patterns + segmentation on one or more datasets.

        With ``checkpoint_dir``, the annealing loop checkpoints its
        state every ``checkpoint_every`` annealing steps under the
        resilience guard and a later call resumes after preemption.
        Checkpointing requires the fused path (equal-shape datasets, no
        ``split_merge``); otherwise the request is logged and ignored.

        Example
        -------
        >>> es = EventSegment(n_events=8)
        >>> es.fit(data, checkpoint_dir="/ckpts/ev1")  # resumable
        """
        X = self._fit_validate(X)
        n_train = len(X)
        self.classes_ = np.arange(self.n_events)

        same_shape = all(x.shape == X[0].shape for x in X)
        if same_shape and not self.split_merge and self.n_iter >= 1 \
                and not getattr(self, "_force_host_loop", False):
            return self._fit_fused(X, checkpoint_dir=checkpoint_dir,
                                   checkpoint_every=checkpoint_every)
        if checkpoint_dir is not None:
            logger.warning(
                "checkpoint_dir is only supported on the fused fit "
                "path (equal-shape datasets, no split_merge); "
                "continuing without checkpointing")

        log_gamma = [np.zeros((x.shape[1], self.n_events)) for x in X]
        step = 1
        best_ll = float("-inf")
        self.ll_ = np.empty((0, n_train))
        while step <= self.n_iter:
            iteration_var = self.step_var(step)

            seg_prob = [np.exp(lg) / np.sum(np.exp(lg), axis=0)
                        for lg in log_gamma]
            mean_pat = np.mean(
                [X[i] @ seg_prob[i] for i in range(n_train)], axis=0)

            self.ll_ = np.append(self.ll_, np.empty((1, n_train)), axis=0)
            for i in range(n_train):
                logprob = self._logprob_obs(X[i], mean_pat, iteration_var)
                log_gamma[i], self.ll_[-1, i] = \
                    self._forward_backward(logprob)
            # non-finite guard (NaN only: -inf log-probabilities are
            # legitimate zero-probability states)
            check_state({"event_pat": mean_pat,
                         "log_likelihood": self.ll_[-1]},
                        iteration=step, where="EventSegment.fit",
                        nan_only=True)

            if step > 1 and self.split_merge:
                curr_ll = np.mean(self.ll_[-1, :])
                self.ll_[-1, :], log_gamma, mean_pat = \
                    self._split_merge(X, log_gamma, iteration_var, curr_ll)

            if np.mean(self.ll_[-1, :]) < best_ll:
                self.ll_ = self.ll_[:-1, :]
                break

            self.segments_ = [np.exp(lg) for lg in log_gamma]
            self.event_var_ = iteration_var
            self.event_pat_ = mean_pat
            best_ll = np.mean(self.ll_[-1, :])
            logger.debug("Fitting step %d, LL=%f", step, best_ll)
            step += 1
        return self

    def _fit_args(self, X):
        """The fused fit's device inputs, in the data's dtype: the
        stacked datasets and (var_schedule, log_P, log_p_start,
        log_p_end)."""
        t = X[0].shape[1]
        log_P, log_p_start, log_p_end = self._build_transitions(t)
        var_schedule = np.stack(
            [np.broadcast_to(np.asarray(self.step_var(s), dtype=float),
                             (self.n_events,))
             for s in range(1, self.n_iter + 1)])
        x = np.stack(X)
        dtype = np.result_type(x.dtype, np.float32)
        return self._tensor(x, dtype), tuple(
            self._tensor(a, dtype)
            for a in (var_schedule, log_P, log_p_start, log_p_end))

    def _fit_fused(self, X, checkpoint_dir=None, checkpoint_every=5):
        """Equal-shape, no-split-merge fit through the device loop of
        :func:`_fit_core_chunk` (same iterates as the host loop,
        exercised against it in tests)."""
        x, args = self._fit_args(X)
        if checkpoint_dir is None:
            # the resilient loop emits this span on the checkpointed
            # path; emitting it here too marks unchunked fits alike
            with obs_spans.span(
                    "fit_chunk",
                    attrs={"estimator": "EventSegment.fit",
                           "step": 0, "n_steps": int(self.n_iter)}):
                best_lg, best_pat, best_var, ll_hist, n_acc = \
                    _fit_core(x, *args)
        else:
            best_lg, best_pat, best_var, ll_hist, n_acc = \
                self._fit_fused_checkpointed(
                    X, x, args, checkpoint_dir, checkpoint_every)
        n_acc = int(n_acc)
        self.ll_ = np.asarray(_host(ll_hist))[:n_acc]
        best_lg = np.asarray(_host(best_lg))
        self.segments_ = [np.exp(best_lg[i]) for i in range(len(X))]
        self.event_pat_ = np.asarray(_host(best_pat))
        # the host loop stores step_var's return value verbatim (scalar
        # or per-event array) for the last ACCEPTED step; re-evaluate
        # the schedule rather than type-munging the device copy
        self.event_var_ = self.step_var(n_acc)
        logger.debug("Fused fit: %d annealing steps, LL=%f", n_acc,
                     float(np.mean(self.ll_[-1])) if n_acc else
                     float("-inf"))
        return self

    @staticmethod
    def _ll_tail(state):
        """Progress objective: the newest finite log-likelihood in
        the NaN-padded ``ll_hist`` ring (None until one lands)."""
        ll = np.asarray(state["ll_hist"], dtype=float)
        ll = ll.reshape(ll.shape[0], -1) if ll.ndim > 1 \
            else ll.reshape(-1, 1)
        filled = np.flatnonzero(np.isfinite(ll).all(axis=1))
        return float(ll[filled[-1]].mean()) if filled.size else None

    def _fit_fused_checkpointed(self, X, x, args, checkpoint_dir,
                                checkpoint_every):
        """Chunked annealing under :func:`run_resilient_loop`.

        The state tuple round-trips through a flat dict of host arrays
        a chunk; ``ll_hist`` is exempt from the guard (NaN-padded by
        design) and the guard is NaN-only (log-domain state contains
        legitimate ``-inf``)."""
        def to_dict(st):
            step, done = st[:2]
            return dict({"step": np.asarray(step, dtype=np.int32),
                         "done": np.asarray(done)},
                        **{k: _host(v)
                           for k, v in zip(_FIT_STATE_KEYS[2:], st[2:])})

        def to_tuple(sd):
            return (int(np.asarray(sd["step"])),
                    bool(np.asarray(sd["done"]))) + tuple(
                torch.as_tensor(np.asarray(sd[k]), dtype=x.dtype,
                                device=x.device)
                for k in _FIT_STATE_KEYS[2:])

        def run_chunk(sd, step, n_steps):
            out = _fit_core_chunk(x, *args, to_tuple(sd), step + n_steps)
            out_d = to_dict(out)
            return out_d, bool(np.asarray(out_d["done"]))

        # n_iter is part of the fingerprint: the checkpointed ll_hist
        # is sized [n_iter, S], so resuming under a different budget
        # would index out of bounds.  array_digest, not a plain sum: X
        # is z-scored by _fit_validate, so its sum is ~0 for ANY data.
        fingerprint = np.array(
            [array_digest(*X), float(len(X)),
             float(X[0].shape[0]), float(X[0].shape[1]),
             float(self.n_events), float(self.n_iter)])
        init = to_dict(_fit_core_init(x, args[0]))
        state, _ = run_resilient_loop(
            run_chunk, init, self.n_iter,
            checkpoint_dir=checkpoint_dir,
            checkpoint_every=checkpoint_every,
            fingerprint=fingerprint, name="EventSegment.fit",
            guard_skip=("ll_hist",), guard_nan_only=True,
            progress_objective=self._ll_tail,
            progress_direction="max")
        n_acc = int(np.asarray(state["step"])) - \
            int(np.asarray(state["done"]))
        return (state["best_lg"], state["best_pat"], state["best_var"],
                state["ll_hist"], n_acc)

    # -- inference -------------------------------------------------------
    def set_event_patterns(self, event_pat):
        """Set event patterns without fitting."""
        if event_pat.shape[1] != self.n_events:
            raise ValueError("Number of columns of event_pat must match "
                             "number of events")
        self.event_pat_ = event_pat.copy()

    def find_events(self, testing_data, var=None, scramble=False):
        """Segment a new dataset with the learned patterns; returns
        (segments [T, K], test_ll)."""
        if var is None:
            if not hasattr(self, 'event_var_'):
                raise NotFittedError("Event variance must be provided, if "
                                     "not previously set by fit()")
            var = self.event_var_
        if not hasattr(self, 'event_pat_'):
            raise NotFittedError("The event patterns must first be set "
                                 "by fit() or set_event_patterns()")
        if scramble:
            mean_pat = self.event_pat_[
                :, np.random.permutation(self.n_events)]
        else:
            mean_pat = self.event_pat_
        logprob = self._logprob_obs(testing_data.T, mean_pat, var)
        lg, test_ll = self._forward_backward(logprob)
        return np.exp(lg), test_ll

    def predict(self, X):
        """Most likely event per timepoint."""
        missing = [a for a in ("event_pat_", "event_var_")
                   if not hasattr(self, a)]
        if missing:
            raise NotFittedError(
                "This EventSegment instance is not fitted yet; call "
                "'fit' first ({} missing)".format(", ".join(missing)))
        X = _check_array(X)
        segments, _ = self.find_events(X)
        return np.argmax(segments, axis=1)

    def calc_weighted_event_var(self, D, weights, event_pat):
        """Weighted variance of timepoints around each event pattern."""
        Dz = stats.zscore(D, axis=1, ddof=1)
        ev_var = np.empty(event_pat.shape[1])
        for e in range(event_pat.shape[1]):
            nz = weights[:, e] > np.max(weights[:, e]) / 1000
            sumsq = np.dot(weights[nz, e],
                           np.sum(np.square(Dz[nz, :] - event_pat[:, e]),
                                  axis=1))
            ev_var[e] = sumsq / (np.sum(weights[nz, e]) -
                                 np.sum(np.square(weights[nz, e])) /
                                 np.sum(weights[nz, e]))
        return ev_var / D.shape[1]

    def model_prior(self, t):
        """Prior segmentation (forward-backward with no data)."""
        lg, test_ll = self._forward_backward(
            np.zeros((t, self.n_events)))
        return np.exp(lg), test_ll

    # -- split/merge proposals ------------------------------------------
    def _subevent_patterns(self, X, seg_prob):
        """Data-weighted patterns for each event's two temporal halves
        and for each adjacent event pair, pooled over datasets.

        The half boundary of event e is the first timepoint at which its
        cumulative soft-assignment mass reaches 1/2; the pair weighting
        is the mean of the two neighbours' assignments.  Returns
        (first [V, K], second [V, K], pairs [V, K-1]).
        """
        first_acc, second_acc, pair_acc = [], [], []
        for x, sp in zip(X, seg_prob):
            t = sp.shape[0]
            cs = np.cumsum(sp, axis=0)
            mid = np.argmax(cs >= 0.5, axis=0)                     # [K]
            mass_before = np.take_along_axis(
                cs - sp, mid[None, :], axis=0)[0]                  # [K]
            before = np.arange(t)[:, None] < mid[None, :]          # [T, K]
            # mid == 0 means an empty first half (mass_before == 0); its
            # weights are identically zero, so guard the 0/0.
            denom = np.where(mass_before > 0, mass_before, 1.0)
            w_first = np.where(before, sp, 0.0) / denom
            w_second = np.where(before, 0.0, sp) / (1.0 - mass_before)
            w_pair = 0.5 * (sp[:, :-1] + sp[:, 1:])
            first_acc.append(x @ w_first)
            second_acc.append(x @ w_second)
            pair_acc.append(x @ w_pair)
        return (np.mean(first_acc, axis=0), np.mean(second_acc, axis=0),
                np.mean(pair_acc, axis=0))

    def _recombined_pattern(self, mean_pat, first, second, pairs, m, s):
        """Candidate pattern matrix with events (m, m+1) replaced in
        place by their pooled pattern and event s by its two halves --
        the event count is unchanged."""
        cols = []
        e = 0
        while e < self.n_events:
            if e == s:
                cols.append(first[:, s])
                cols.append(second[:, s])
                e += 1
            elif e == m:
                cols.append(pairs[:, m])
                e += 2
            else:
                cols.append(mean_pat[:, e])
                e += 1
        return np.column_stack(cols)

    def _split_merge(self, X, log_gamma, iteration_var, curr_ll):
        """Escape short-event local minima by jointly merging one
        adjacent event pair and splitting one other event in two; the
        move is kept only if it raises the mean log-likelihood.

        Proposal building blocks come from vectorized masking
        (``_subevent_patterns``), are scored with columnwise
        correlations, and ALL candidate segmentations are evaluated in
        one batched forward-backward a dataset
        (:func:`_segment_candidates_core`).
        """
        n_train = len(X)

        seg_prob = [np.exp(lg) / np.sum(np.exp(lg), axis=0)
                    for lg in log_gamma]
        mean_pat = np.mean(
            [X[i] @ seg_prob[i] for i in range(n_train)], axis=0)

        first, second, pairs = self._subevent_patterns(X, seg_prob)

        # A pair (e, e+1) is mergeable when the pooled pattern still
        # correlates with BOTH originals (min over the pair, high); an
        # event is splittable when even its better-matching half
        # correlates poorly with the full pattern (max over halves, low).
        merge_support = np.minimum(
            _column_corr(pairs, mean_pat[:, :-1]),
            _column_corr(pairs, mean_pat[:, 1:]))
        split_support = np.maximum(
            _column_corr(first, mean_pat),
            _column_corr(second, mean_pat))

        n_prop = self.split_merge_proposals
        merge_rank = np.argsort(-merge_support)[:n_prop]
        split_rank = np.argsort(split_support)[:n_prop]
        candidates = [(m, s) for m in merge_rank for s in split_rank
                      if s != m and s != m + 1]
        if not candidates:
            return curr_ll, log_gamma, mean_pat

        cand_pats = np.stack([
            self._recombined_pattern(mean_pat, first, second, pairs, m, s)
            for m, s in candidates])

        var_vec = np.full((self.n_events,), iteration_var, dtype=float)
        ll = np.zeros((len(candidates), n_train))
        cand_lg = []
        for i in range(n_train):
            t = X[i].shape[1]
            log_P, log_p_start, log_p_end = self._build_transitions(t)
            dtype = np.result_type(X[i].dtype, cand_pats.dtype,
                                   np.float32)
            lg_c, ll_c = _segment_candidates_core(
                *(self._tensor(a, dtype) for a in
                  (X[i], cand_pats, var_vec, log_P, log_p_start,
                   log_p_end)))
            cand_lg.append(_host(lg_c)[:, :, :-1])
            ll[:, i] = _host(ll_c)

        means = ll.mean(axis=1)
        means = np.where(np.isnan(means), -np.inf, means)
        best = int(np.argmax(means))
        if not means[best] > np.mean(curr_ll):
            return curr_ll, log_gamma, mean_pat
        m, s = candidates[best]
        logger.debug("Split-merge accepted: merge (%d,%d), split %d",
                     m, m + 1, s)
        return (ll[best], [cand_lg[i][best] for i in range(n_train)],
                cand_pats[best])
