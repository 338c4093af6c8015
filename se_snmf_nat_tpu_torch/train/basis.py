"""Dictionary training on the card (port of ``se_snmf_nat_tpu.train.basis``,
run_basis_train.m).

Feature assembly runs on the host (NumPy); the sparse-NMF factorization,
the offline hot loop (513 x ~72k KL MU trips, SURVEY §3.4), runs on the
card through ``nmf.solver.snmf_solve``: matrix products and elementwise
passes over V, uploaded once.  It is not a kernel's function: K2 keeps a
lane's W and H in shared memory and cannot hold H at R x 72,000.

Pipeline per event class (run_basis_train.m:11-136):
  cache hit?  ->  load R_<R> checkpoint
  else: build training sequence -> features (DFT + mel) -> exemplar column
  sampling -> [full SNMF solve unless exemplar mode] -> column L2
  normalization (+1e-9) -> optional k-means rank reduction -> checkpoint.
"""

from __future__ import annotations

import json
import warnings
from dataclasses import dataclass, replace
from pathlib import Path

import numpy as np
import torch

from se_snmf_nat_tpu_torch.config import PipelineConfig
from se_snmf_nat_tpu_torch.device import resolve_device
from se_snmf_nat_tpu_torch.io.basis import BasisPair, load_basis, save_basis
from se_snmf_nat_tpu_torch.io.wavio import write_enhanced_wav
from se_snmf_nat_tpu_torch.nmf.solver import SnmfParams, snmf_solve
from se_snmf_nat_tpu_torch.train.dataset import build_training_sequence
from se_snmf_nat_tpu_torch.train.features import (
    TrainingFeatures, training_features)
from se_snmf_nat_tpu_torch.train.kmeans import kmeans_reduce
from se_snmf_nat_tpu_torch.utils.matlab_compat import (
    MatlabTwister, matlab_v4_rand_matrix)


@dataclass
class BasisTrainResult:
    basis: BasisPair
    a_dft: np.ndarray | None     # final activations (None in exemplar mode)
    a_mel: np.ndarray | None
    n_frames: int
    iters_dft: int = 0
    iters_mel: int = 0


def exemplar_sample_idx(n_frames: int, count: int, seed: int = 1) -> np.ndarray:
    """Deterministic exemplar column sampling: the first ``count`` indices
    of a stable sort of MATLAB's mt19937ar ``rand(1, n_frames)`` after
    ``rng(seed)`` (run_basis_train.m:80-81 draws with randsample, whose use
    of the stream is undocumented: seeded and deterministic, not bit-equal
    to MATLAB's draw)."""
    tw = MatlabTwister(seed)
    u = tw.rand(1, n_frames).reshape(-1)
    return np.argsort(u, kind="stable")[:count]


def snmf_params(cfg: PipelineConfig) -> SnmfParams:
    """The training and DNMF solves' parameters (``flr`` 1e-9)."""
    return SnmfParams(beta=cfg.nmf.beta, sparsity=float(cfg.nmf.sparsity),
                      max_iter=cfg.nmf.max_iter, conv_eps=cfg.nmf.conv_eps,
                      flr=1e-9)


def _solve_full(v: np.ndarray, w0: np.ndarray, cfg: PipelineConfig, dtype,
                device: torch.device
                ) -> tuple[np.ndarray, np.ndarray, int]:
    """Full (W+H) sparse-NMF solve on ``device``: V uploaded once as
    ``dtype``; H init from the reference's per-solve reseeded legacy stream
    (sparse_nmf.m:112-134)."""
    r = w0.shape[1]
    h0 = matlab_v4_rand_matrix(r, v.shape[1], cfg.nmf.random_seed)
    mask = torch.ones(r, dtype=torch.bool, device=device)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)  # noqa
    res = snmf_solve(t(v), t(w0), t(h0), mask, mask, snmf_params(cfg),
                     update_w=True, update_h=True)
    return res.w.cpu().numpy(), res.h.cpu().numpy(), int(res.iters)


def _normalize_plus_eps(b: np.ndarray) -> np.ndarray:
    """Column L2 normalize then +1e-9 (run_basis_train.m:112-116)."""
    wn = np.sqrt(np.sum(b * b, axis=0))
    return b / wn + 1e-9


def train_event_basis(
    features: TrainingFeatures, cfg: PipelineConfig, r: int, *,
    dtype=torch.float32, device=None,
    kmeans_rng: np.random.Generator | None = None, exemplar_seed: int = 1,
) -> BasisTrainResult:
    """Train one event class's (DFT, mel) dictionary pair from features,
    the two solves on ``device`` (the card unless named) in ``dtype``.

    ``exemplar_seed``: seed of the exemplar column draw (reference default
    rng(1), run_basis_train.m:80)."""
    device = resolve_device(device)
    t = features.tf_mag.shape[1]
    count = cfg.train.cluster_buff * r
    if count > t:
        raise ValueError(f"need >= {count} frames, got {t}")
    idx = exemplar_sample_idx(t, count, seed=exemplar_seed)
    b_dft = features.tf_mag[:, idx]
    b_mel = features.tf_mel[:, idx]

    a_dft = a_mel = None
    it_d = it_m = 0
    if not cfg.train.train_exemplar:
        b_dft, a_dft, it_d = _solve_full(features.tf_mag, b_dft, cfg, dtype,
                                         device)
        b_mel, a_mel, it_m = _solve_full(features.tf_mel, b_mel, cfg, dtype,
                                         device)

    b_dft = _normalize_plus_eps(b_dft)
    b_mel = _normalize_plus_eps(b_mel)

    if cfg.train.cluster_buff > 1:
        keep = kmeans_reduce(b_mel, r, rng=kmeans_rng)
        b_dft, b_mel = b_dft[:, keep], b_mel[:, keep]
        if a_dft is not None:
            a_dft, a_mel = a_dft[keep, :], a_mel[keep, :]

    return BasisTrainResult(basis=BasisPair(b_dft=b_dft, b_mel=b_mel),
                            a_dft=a_dft, a_mel=a_mel, n_frames=t,
                            iters_dft=it_d, iters_mel=it_m)


def train_event_basis_cached(
    db_path: str | Path, basis_dir: str | Path, cfg: PipelineConfig, r: int,
    *, dc_freq: float | None = None, vad: bool = False,
    force_retrain: bool = False, dtype=torch.float32, device=None,
    shuffle_rng: np.random.Generator | None = None,
    save_sequence: bool = False,
) -> BasisPair:
    """Cache-aware per-class training (run_basis_train.m:11-12,136-138).

    Checkpoints land at <basis_dir>/R_<r>.npz, the same file the reference
    package writes and reads; a hit short-circuits training unless
    force_retrain.  The cache key is the rank only, as the reference's
    R_<R>.mat inside a per-config directory; a sidecar R_<r>.opts.json
    records the options, and a hit under different ones warns.  dc_freq
    overrides the config's DC zeroing cutoff per class
    (Do_MultiBatch_IS16_20160324_CHiME4.m:95-107).  The solves run on
    ``device`` (the card unless named)."""
    device = resolve_device(device)
    basis_dir = Path(basis_dir)
    ckpt = basis_dir / f"R_{r}.npz"
    opts = {"vad": bool(vad), "dc_freq": dc_freq}
    sidecar = basis_dir / f"R_{r}.opts.json"
    if ckpt.exists() and not force_retrain:
        if sidecar.exists():
            stale = json.loads(sidecar.read_text())
            if {k: stale.get(k) for k in ("vad", "dc_freq")} != opts:
                warnings.warn(
                    f"{ckpt}: cache hit with different training options "
                    f"(cached {stale}, requested vad={vad} "
                    f"dc_freq={dc_freq}); pass force_retrain/--force to "
                    f"retrain", stacklevel=2)
        return load_basis(ckpt)

    sig = cfg.signal
    dc_bin = (sig.dc_bin if dc_freq is None else
              replace(sig, dc_freq=dc_freq).dc_bin)
    seq, _spec = build_training_sequence(db_path, cfg, vad=vad,
                                         rng=shuffle_rng)
    feats = training_features(seq, cfg, dc_bin=dc_bin)
    result = train_event_basis(feats, cfg, r, dtype=dtype, device=device)

    basis_dir.mkdir(parents=True, exist_ok=True)
    save_basis(ckpt, result.basis)
    sidecar.write_text(json.dumps(opts))
    if save_sequence:
        write_enhanced_wav(basis_dir / "train_seq.wav", seq, sig.fs)
    return result.basis


def train_event_bases(
    db_paths: list[str | Path], basis_dirs: list[str | Path],
    cfg: PipelineConfig, r: int, *, dc_freqs: list[float] | None = None,
    vad_flags: list[bool] | None = None, **kw,
) -> BasisPair:
    """Multi-class wrapper: train/load each class and concatenate columns
    (run_basis_train.m:5-6,142-143 block layout: class l fills columns
    [l*R, (l+1)*R))."""
    n = len(db_paths)
    dc_freqs = dc_freqs or [None] * n
    vad_flags = vad_flags or [False] * n
    pairs = [
        train_event_basis_cached(db, bd, cfg, r, dc_freq=dc, vad=v, **kw)
        for db, bd, dc, v in zip(db_paths, basis_dirs, dc_freqs, vad_flags)
    ]
    return BasisPair(
        b_dft=np.concatenate([p.b_dft for p in pairs], axis=1),
        b_mel=np.concatenate([p.b_mel for p in pairs], axis=1),
    )
