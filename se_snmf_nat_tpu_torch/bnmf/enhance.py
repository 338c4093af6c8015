"""Bayesian-NMF speech enhancer (Mohammadiha TASLP 2013) on the card — the
reference's third algorithm slot.  Counterpart of the reference package's
``bnmf/enhance.py``, whose docstring sets out what proc_BNMF_nmoh.m pins
down and what it reconstructs:

  * framing: alen=512 / ulen=256 (:23), periodic Hann normalized by
    sqrt(sum(win^2)) (:117-119), per-frame fft -> 257 bins (:122),
    magnitude scaled by spec_scale=5 (:42,123), synthesis by
    conj-symmetric ifft of (1/5)*Est*exp(i*angle(Y)) with DC/Nyquist
    forced real, scaled back by norm_coef, plain overlap-add (:131-135);
  * speech model: R_x-component VB-NMF on the unit-variance speech
    signal's scaled magnitude spectrogram, 100 iterations (:46-53);
  * online noise model: 15 components trained on the first 15*ulen
    samples of the mixture, 1000 iterations, posterior shapes clamped to
    >= 200 (:86-104), a 50-column noise-frame buffer (:89-97), activation
    prior shapes phi_s=0 and phi_n=100 (:110), WADA long-term SNR
    tracking (:139-155);
  * reconstructed (the @NMF class is absent): the Wiener-style MMSE
    magnitude, exponentially smoothed activation priors, and a streaming-VB
    refit of the noise basis every ``refit_every`` pushes of a frame whose
    instantaneous SNR falls below the long-term one.

The frame loop is a Python loop on the host.  Every frame's rfft is taken
before it and every frame's irfft after it (they depend on no carry); the
loop runs the per-frame VB inference (``n_infer`` H blocks against the
fixed speech and noise bases) and the buffer and WADA bookkeeping.  The
refit is data-dependent: whether a frame is pushed is decided on the card,
so the loop reads that one flag on the host once a frame and runs
``_noise_refit`` (``n_refit`` VB trips) only when the pushes reach
``refit_every`` — computing it every frame and selecting would double a
frame's work.  One utterance at a time, as in the reference package.
``method='supervised'`` factorizes all frames in one solve (columns =
frames) against fixed speech and noise models.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from se_snmf_nat_tpu_torch.bnmf.vb import (
    GammaPost, _h_block, _h_scale, clamp_min_shape, h_prior, init_train,
    vb_h_infer, vb_train)
from se_snmf_nat_tpu_torch.device import full_f32, resolve_device
from se_snmf_nat_tpu_torch.io.wavio import enhanced_quantize

_EPS = 2.220446049250313e-16        # MATLAB eps, used in the WADA log
_FLR = 1e-30

# WADA calibration: quadratic through the published table
# (proc_BNMF_nmoh.m:150-152; Kim & Stern Interspeech 2008)
_WADA_SNRS = np.array([-5.0, 0.0, 10.0, 20.0])
_WADA_G = np.array([0.423, 0.442, 0.642, 0.885])
_WADA_POLY = np.polyfit(_WADA_SNRS, _WADA_G, 2)     # p1 x^2 + p2 x + p3


class BnmfParams(NamedTuple):
    alen: int = 512                 # analysis length (:23)
    ulen: int = 256                 # update (hop) length (:23)
    spec_scale: float = 5.0         # (:42)
    k_speech: int = 100             # p.R_x (:48)
    k_noise: int = 15               # online (:85); supervised uses R_d
    a_noise: float = 100.0          # phi^(n) online (:87); 10 supervised
    train_iters: int = 100          # speech model max_it (:51)
    noise_init_iters: int = 1000    # online noise max_it (:99)
    min_noise_shape: float = 200.0  # adjust_ShapeparamBasis (:104)
    n_infer: int = 25               # per-frame VB iterations (class
                                    # internal; free choice)
    k_noise_supervised: int = 100   # num_noise_basis = p.R_d (:68)
    buffer_len: int = 50            # noise buffer columns (:89)
    refit_every: int = 10           # pushes between refits (free: the
                                    # wrapper's +10 counter)
    n_refit: int = 10               # VB iterations per refit (free)
    rho: float = 0.9                # prior forgetting on refit (free)
    prior_smooth: float = 0.9       # activation-prior smoothing (free)
    snr_smooth: float = 0.998       # WADA recursion (:154)
    wada_win: int = 50              # frames in the G window (:145)
    init_hops: int = 15             # noise-only head, in hops (:88)


class BnmfModel(NamedTuple):
    """Trained speech model: basis posterior + mean activation levels
    (the data-driven init/prior means for inference)."""
    w: GammaPost                    # (F, K_s)
    u0: torch.Tensor                # (K_s, 1) mean training activation


class OnlineCarry(NamedTuple):
    """The online frame loop's state.  The buffer pointer, the push count
    and the WADA ring pointer are host integers (the loop reads the push
    flag on the host once a frame); the rest lives on the device."""
    wn: GammaPost                   # noise basis posterior (F, K_n)
    u_s: torch.Tensor               # (K_s, 1) speech activation prior means
    u_n: torch.Tensor               # (K_n, 1) noise activation prior means
    buf: torch.Tensor               # (F, buffer_len) noise-frame buffer
    bmask: torch.Tensor             # (buffer_len,) valid buffer columns
    bptr: int
    newc: int                       # pushes since the last refit
    ring1: torch.Tensor             # (wada_win,) sum |hop| per hop
    ring2: torch.Tensor             # (wada_win,) sum log(|hop| + eps)
    rptr: int
    snr_lt: torch.Tensor            # () long-term WADA SNR


def _safe_std(x: np.ndarray) -> float:
    """MATLAB-style unit-variance normalizer with a silence guard: a
    zero-variance stretch (digital silence, muted capture) must not put
    NaN through the whole pipeline (the wrapper divides unguarded,
    proc_BNMF_nmoh.m:31,88 — a deliberate robustness deviation)."""
    s = float(np.sqrt(np.var(np.asarray(x, np.float64), ddof=1)))
    return s if s > 0.0 and np.isfinite(s) else 1.0


def _window(alen: int) -> np.ndarray:
    n = np.arange(alen)
    win = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / alen)    # hann periodic
    return win / np.sqrt(np.sum(win ** 2))              # :118-119


def _frame(x: np.ndarray, alen: int, ulen: int) -> np.ndarray:
    """(T, alen) frames at hop ulen, T = floor(len/ulen) - 1 (:121,129)."""
    t = len(x) // ulen - 1
    if t <= 0:
        return np.zeros((0, alen), x.dtype)
    idx = np.arange(alen)[None, :] + ulen * np.arange(t)[:, None]
    return x[idx]


def spectrogram(x: np.ndarray, p: BnmfParams) -> np.ndarray:
    """Scaled magnitude spectrogram (F, T) of a raw signal — the
    MySpectrogram role (assumed same framing/window as the main loop)."""
    frames = _frame(np.asarray(x, np.float64), p.alen, p.ulen)
    spec = np.fft.rfft(frames * _window(p.alen)[None, :], axis=1)
    return p.spec_scale * np.abs(spec).T


def _vb_fit(spect: np.ndarray, k: int, n_iter: int, seed: int, dtype,
            device, trace_bound: bool = False):
    """``vb_train`` of ``k`` components on a host spectrogram from
    ``init_train``'s seeded start: (w posterior, mean activations (k, 1),
    bound trace)."""
    w0, h0, b0w, b0h = init_train(spect, k, seed=seed)

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    w, h, trace = vb_train(t(spect), t(w0), t(h0), b0w, b0h, n_iter=n_iter,
                           trace_bound=trace_bound)
    return w, torch.mean(h.mean, dim=1, keepdim=True), trace


def train_speech_model(speech: np.ndarray, p: BnmfParams,
                       dtype=torch.float32, seed: int = 0,
                       trace_bound: bool = False, device=None):
    """VB speech model from a clean-speech signal (proc_BNMF_nmoh.m:46-53:
    unit-variance normalize, 5x magnitude spectrogram, R_x components,
    100 iterations), on the card unless ``device`` names another.
    Returns (BnmfModel, bound_trace)."""
    full_f32()
    device = resolve_device(device)
    speech = np.asarray(speech, np.float64)
    speech = speech / _safe_std(speech)                 # MATLAB var (:31)
    w, u0, trace = _vb_fit(spectrogram(speech, p), p.k_speech,
                           p.train_iters, seed, dtype, device, trace_bound)
    return BnmfModel(w, u0), trace


def _train_noise_init(mixed: np.ndarray, p: BnmfParams, dtype, device,
                      seed=1):
    """Online-mode noise init from the first init_hops*ulen mixture
    samples (:85-99): unit-variance normalize, spectrogram, K_noise
    components, noise_init_iters, shape clamp."""
    head = np.asarray(mixed[: p.init_hops * p.ulen], np.float64)
    head = head / _safe_std(head)
    nos = spectrogram(head, p)
    w, u0, _ = _vb_fit(nos, p.k_noise, p.noise_init_iters, seed, dtype,
                       device)
    return clamp_min_shape(w, p.min_noise_shape), u0, nos


def _noise_refit(wn: GammaPost, buf, mask, p: BnmfParams, b0h: float):
    """Streaming-VB refit of the noise basis on the (F, buffer_len)
    buffer.  Prior = previous posterior down-weighted by rho; invalid
    buffer columns are masked out of every statistic."""
    x = torch.clamp_min(buf, _FLR)
    k = wn.shape.shape[1]
    a0_w = p.rho * wn.shape
    r0_w = p.rho / wn.scale
    u = torch.full((k, buf.shape[1]), b0h, dtype=x.dtype, device=x.device)
    h = GammaPost(torch.ones_like(u), u)
    w = wn
    lh = h.explog()
    for _ in range(p.n_refit):
        lw = w.explog()
        h = _h_block(x, lw, lh, 1.0,
                     _h_scale(1.0 / b0h, torch.sum(w.mean, 0)[:, None]))
        lh = h.explog()
        lh_m = lh * mask[None, :]
        eh_rowsum = torch.sum(h.mean * mask[None, :], 1)[None, :]
        lam = torch.clamp_min(lw @ lh_m, _FLR)
        sw = lw * (((x / lam) * mask[None, :]) @ lh_m.T)
        shape = a0_w + sw
        scale = 1.0 / (r0_w + eh_rowsum)
        w = GammaPost(torch.clamp_min(shape, 1e-12), scale)
    return clamp_min_shape(w, p.min_noise_shape)


class BnmfEnhancer:
    """Online (default) or supervised BNMF enhancer, on the card unless
    ``device`` names another.

    ``model``: a trained BnmfModel, or pass ``speech=<signal>`` to train
    one here.  Online mode needs nothing else (noise model self-
    initializes from the head of each input); supervised mode needs
    ``noise=<signal>`` (trains a fixed noise model, no adaptation).
    ``refits`` counts the noise refits the online loop has run.
    """

    def __init__(self, model: BnmfModel | None = None, *,
                 speech: np.ndarray | None = None,
                 noise: np.ndarray | None = None,
                 method: str = "online",
                 params: BnmfParams | None = None,
                 dtype=torch.float32, seed: int = 0, device=None):
        self.p = params or BnmfParams()
        if self.p.alen != 2 * self.p.ulen:
            # _frame/_ola implement exactly the reference's 50%-overlap
            # sqrt-Hann chain (proc_BNMF_nmoh.m:23); other ratios would
            # silently mis-frame, so reject them up front
            raise ValueError(
                f"BnmfParams requires alen == 2*ulen "
                f"(got alen={self.p.alen}, ulen={self.p.ulen})")
        full_f32()
        self.device = resolve_device(device)
        self.dtype = dtype
        self.method = method
        if model is None:
            if speech is None:
                raise ValueError("need a BnmfModel or a speech signal")
            model, _ = train_speech_model(speech, self.p, dtype, seed,
                                          device=self.device)
        self.model = model
        self.noise_model = None
        if method == "supervised":
            if noise is None:
                raise ValueError("supervised mode needs a noise signal")
            noise = np.asarray(noise, np.float64)
            noise = noise / _safe_std(noise)
            # supervised noise rank is R_d-scale (num_noise_basis = p.R_d,
            # proc_BNMF_nmoh.m:68), NOT the online path's 15-atom model
            w, u0, _ = _vb_fit(spectrogram(noise, self.p),
                               self.p.k_noise_supervised, self.p.train_iters,
                               seed + 1, dtype, self.device)
            self.noise_model = BnmfModel(w, u0)
        self._win = _window(self.p.alen)
        self._win_t = self._t(self._win)
        self._speech = None         # the speech model's statistics, lazily
        self.refits = 0

    # ------------------------------------------------------------------
    def _t(self, a) -> torch.Tensor:
        return torch.as_tensor(a, dtype=self.dtype, device=self.device)

    def _speech_stats(self):
        """(LW_s, EW_s, sum_f EW_s, phi, WADA polynomial), built once."""
        if self._speech is None:
            p, dt = self.p, self.dtype
            ws = self.model.w
            lw_s = ws.explog().to(dt)
            ew_s = ws.mean.to(dt)
            k_s = lw_s.shape[1]
            phi = torch.cat([torch.zeros((k_s, 1), dtype=dt,
                                         device=self.device),
                             torch.full((p.k_noise, 1), p.a_noise, dtype=dt,
                                        device=self.device)])
            self._speech = (lw_s, ew_s, torch.sum(ew_s, 0)[:, None], phi,
                            self._t(_WADA_POLY))
        return self._speech

    def run_frames(self, carry: OnlineCarry, frames: torch.Tensor,
                   l0: int):
        """Run the online loop over ``frames`` ((k, alen), already divided
        by the head's scale, on the device), the first of them frame ``l0``
        (1-based).  Returns (carry, the frames' synthesized (k, alen)
        waveforms).  Shared by ``enhance`` and ``BnmfStreamingSession``."""
        p = self.p
        lw_s, ew_s, ews_colsum, phi, poly = self._speech_stats()
        k_s = lw_s.shape[1]
        sm = p.prior_smooth
        n_samp = p.wada_win * p.ulen
        spec = torch.fft.rfft(frames * self._win_t, dim=-1)
        ys = torch.clamp_min(p.spec_scale * spec.abs(), _FLR)
        (wn, u_s, u_n, buf, bmask, bptr, newc, ring1, ring2, rptr,
         snr_lt) = carry
        noise_stats = None
        s_hats = []
        for i in range(frames.shape[0]):
            l = l0 + i
            y = ys[i][:, None]
            if noise_stats is None:
                # the noise basis's statistics change only at a refit
                lw = torch.cat([lw_s, wn.explog()], dim=1)
                ew = torch.cat([ew_s, wn.mean], dim=1)
                ew_colsum = torch.cat(
                    [ews_colsum, torch.sum(wn.mean, 0)[:, None]], dim=0)
                noise_stats = (lw, ew, ew_colsum)
            lw, ew, ew_colsum = noise_stats
            h, inv_rate = h_prior(torch.cat([u_s, u_n], dim=0), phi)
            scale = _h_scale(inv_rate, ew_colsum)
            for _ in range(p.n_infer):
                h = _h_block(y, lw, h.explog(), phi, scale)
            eh = h.mean
            lam_s = ew[:, :k_s] @ eh[:k_s]
            lam_n = ew[:, k_s:] @ eh[k_s:]
            s_hat = lam_s / torch.clamp_min(lam_s + lam_n, _FLR) * y
            s_hats.append(s_hat[:, 0])

            # temporal priors (TASLP §III.C): exponential smoothing
            u_s = sm * u_s + (1.0 - sm) * eh[:k_s]
            u_n = sm * u_n + (1.0 - sm) * eh[k_s:]

            # noise-dominated detection + buffer push (§III.B); the one
            # value of a frame the host reads
            if l <= p.init_hops:
                push = True
            else:
                e_s = torch.sum(s_hat ** 2)
                e_n = torch.sum((y - s_hat) ** 2)
                inst = 10.0 * torch.log10(torch.clamp_min(e_s, _FLR)
                                          / torch.clamp_min(e_n, _FLR))
                push = bool(inst < snr_lt)
            if push:
                buf[:, bptr] = y[:, 0]
                bmask[bptr] = 1.0
                bptr = (bptr + 1) % p.buffer_len
                newc += 1
            if newc >= p.refit_every:
                # periodic streaming refit of the noise basis
                wn = _noise_refit(wn, buf, bmask, p, 1.0)
                newc = 0
                noise_stats = None
                self.refits += 1

            # WADA long-term SNR (:139-155): stats of the hop ending at
            # this frame's midpoint, window = last wada_win hops
            hop = frames[i, : p.ulen]
            ring1[rptr] = torch.sum(torch.abs(hop))
            ring2[rptr] = torch.sum(torch.log(torch.abs(hop) + _EPS))
            rptr = (rptr + 1) % p.wada_win
            if l > p.wada_win:
                g = (torch.log(torch.sum(ring1) / n_samp)
                     - torch.sum(ring2) / n_samp)
                # min-|root| of p1 x^2 + p2 x + (p3 - g) (:153); complex
                # pair -> common real part (deviation: MATLAB would
                # propagate the complex root into the recursion)
                p1, p2, p3 = poly[0], poly[1], poly[2]
                disc = p2 * p2 - 4.0 * p1 * (p3 - g)
                sq = torch.sqrt(torch.clamp_min(disc, 0.0))
                r_a = (-p2 + sq) / (2.0 * p1)
                r_b = (-p2 - sq) / (2.0 * p1)
                root = torch.where(disc >= 0.0,
                                   torch.where(torch.abs(r_a) < torch.abs(r_b),
                                               r_a, r_b),
                                   -p2 / (2.0 * p1))
                snr_lt = p.snr_smooth * snr_lt + (1.0 - p.snr_smooth) * root

        # synthesis (:131-135)
        est = (torch.stack(s_hats) / p.spec_scale) \
            * torch.exp(1j * torch.angle(spec))
        est.imag[:, 0] = 0.0
        est.imag[:, -1] = 0.0
        y_t = torch.fft.irfft(est * self._norm_coef, n=p.alen, dim=-1)
        carry = OnlineCarry(wn, u_s, u_n, buf, bmask, bptr, newc, ring1,
                            ring2, rptr, snr_lt)
        return carry, y_t.to(self.dtype)

    # ------------------------------------------------------------------
    @property
    def _norm_coef(self):
        n = np.arange(self.p.alen)
        w = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / self.p.alen)
        return float(np.sqrt(np.sum(w ** 2)))           # :117

    def _ola(self, frames: np.ndarray) -> np.ndarray:
        """Plain overlap-add of (T, alen) frames at hop ulen into a
        (T+1)*ulen signal (:129-135)."""
        p = self.p
        t = frames.shape[0]
        if t == 0:
            return np.zeros(0)
        fh, sh = frames[:, : p.ulen], frames[:, p.ulen:]
        out = np.zeros(((t + 1), p.ulen))
        out[:t] += fh
        out[1:] += sh
        return out.reshape(-1)

    def enhance(self, x: np.ndarray, quantize: bool = True) -> np.ndarray:
        # Scale coherence (deviation): the wrapper trains the noise init
        # on a unit-variance head (:88) but streams raw int16-scale
        # magnitudes (:34-36,123) — only workable if the absent class
        # rescales internally.  We normalize the whole mixture by the
        # noise-head std (supervised: its own std) so the stream and the
        # noise model share one scale, and scale the output back.
        p = self.p
        x = np.asarray(x, np.float64)
        frames_raw = _frame(x, p.alen, p.ulen)
        t = frames_raw.shape[0]
        if t == 0:
            return np.zeros(0, np.int16 if quantize else np.float64)
        if self.method == "supervised":
            sigma = _safe_std(x)
        else:
            sigma = self.head_sigma(x)
        frames = frames_raw / sigma
        if self.method == "supervised":
            y_t = self._enhance_supervised(frames)
        else:
            _, y_t = self.run_frames(self.init_online_carry(x),
                                     self._t(frames), 1)
            y_t = y_t.cpu().numpy().astype(np.float64)
        out = self._ola(y_t) * sigma
        return enhanced_quantize(out) if quantize else out

    def init_online_carry(self, x_head: np.ndarray) -> OnlineCarry:
        """Online-mode loop state from the mixture head (needs at least
        init_hops*ulen samples): trains the noise init (:85-99) and seeds
        the noise-frame buffer (:91-97).  Shared by offline enhance() and
        the push-based BnmfStreamingSession."""
        p, dt = self.p, self.dtype
        wn, u_n0, nos = _train_noise_init(np.asarray(x_head, np.float64),
                                          p, dt, self.device)
        f = nos.shape[0]
        buf = np.zeros((f, p.buffer_len))
        bmask = np.zeros(p.buffer_len)
        ncols = min(nos.shape[1], p.buffer_len)
        buf[:, :ncols] = nos[:, -ncols:]            # :91-97
        bmask[:ncols] = 1.0
        zeros = torch.zeros(p.wada_win, dtype=dt, device=self.device)
        return OnlineCarry(
            wn=GammaPost(wn.shape.to(dt), wn.scale.to(dt)),
            u_s=self.model.u0.to(dt), u_n=u_n0.to(dt),
            buf=self._t(buf), bmask=self._t(bmask),
            bptr=ncols % p.buffer_len, newc=0, ring1=zeros,
            ring2=zeros.clone(), rptr=0,
            snr_lt=torch.zeros((), dtype=dt, device=self.device))

    def head_sigma(self, x_head: np.ndarray) -> float:
        """The noise-head scale the stream is normalized by (see
        enhance() scale-coherence note)."""
        head = np.asarray(x_head, np.float64)[: self.p.init_hops
                                              * self.p.ulen]
        return _safe_std(head)

    def _enhance_supervised(self, frames: np.ndarray) -> np.ndarray:
        """All frames in one VB solve (columns = frames); the transforms on
        the host, as in the reference package."""
        p = self.p
        dt = self.dtype
        spec = np.fft.rfft(frames * self._win[None, :], axis=1)
        y = self._t(p.spec_scale * np.abs(spec).T)
        k_s = self.model.w.shape.shape[1]
        w = GammaPost(
            torch.cat([self.model.w.shape,
                       self.noise_model.w.shape], 1).to(dt),
            torch.cat([self.model.w.scale,
                       self.noise_model.w.scale], 1).to(dt))
        t = y.shape[1]
        k_n = self.noise_model.w.mean.shape[1]   # k_noise_supervised
        u = torch.cat(
            [self.model.u0.expand(k_s, t),
             self.noise_model.u0.expand(k_n, t)]).to(dt)
        phi = torch.cat(
            [torch.zeros((k_s, 1), dtype=dt, device=self.device),
             torch.full((k_n, 1), 10.0, dtype=dt,
                        device=self.device)])             # a_noise=10 (:67)
        h = vb_h_infer(y, w, u, phi, n_iter=p.n_infer)
        eh = h.mean
        lam_s = w.mean[:, :k_s] @ eh[:k_s]
        lam_n = w.mean[:, k_s:] @ eh[k_s:]
        gain = (lam_s / torch.clamp_min(lam_s + lam_n, _FLR)).cpu().numpy() \
            .astype(np.float64)
        est = gain.T * np.abs(spec) * np.exp(1j * np.angle(spec))
        est[:, 0] = est[:, 0].real
        est[:, -1] = est[:, -1].real
        return np.fft.irfft(est * self._norm_coef, n=p.alen, axis=1)
