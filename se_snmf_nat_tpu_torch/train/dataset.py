"""Training-sequence assembly (run_basis_train.m:14-58).

Builds one long training signal per event class from a directory of wavs:
optional shuffled file order, per-file silence stripping (VAD) or
annotation windows or a hard length cap, per-file variance+peak
normalization, concatenation up to a sequence cap.

The port's own copy of the reference package's module of the same name,
held equal to it statement for statement by tests/test_torch_io.py.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np

from se_snmf_nat_tpu_torch.config import PipelineConfig
from se_snmf_nat_tpu_torch.io.wavio import read_wav_normalized
from se_snmf_nat_tpu_torch.train.vad import apply_vad, energy_vad


def load_annotation(filename_stem: str, n_samples: int, fs: int,
                    anno_dir: str | Path = "training_anno"
                    ) -> tuple[int, int] | None:
    """src/load_anot.m: <anno_dir>/<stem>_sid.txt holds start/end seconds;
    returns a 0-based [start, end) sample window, or None if absent."""
    path = Path(anno_dir) / f"{filename_stem}_sid.txt"
    if not path.exists():
        return None
    vals = np.loadtxt(str(path)).reshape(-1)
    start, end = int(np.ceil(vals[0] * fs)), int(np.ceil(vals[1] * fs))
    start = max(start, 1)           # load_anot.m:9-11 (1-based floor)
    end = min(end, n_samples)       # :13-15
    return start - 1, end


def normalize_clip(s: np.ndarray) -> np.ndarray:
    """Unit variance then peak 30000 (run_basis_train.m:44-45).  MATLAB
    var() is the unbiased (N-1) estimator."""
    s = np.asarray(s, dtype=np.float64)
    s = s / np.sqrt(np.var(s, ddof=1))
    return s / np.max(np.abs(s)) * 30000.0


@dataclass
class SequenceSpec:
    files: list[Path]            # ordered files actually consumed
    total_samples: int


def build_training_sequence(
    db_path: str | Path, cfg: PipelineConfig, *,
    vad: bool = False, shuffle: bool = True,
    rng: np.random.Generator | None = None,
    anno_dir: str | Path = "training_anno",
) -> tuple[np.ndarray, SequenceSpec]:
    """Concatenate normalized training clips into one sequence.

    Reference semantics (run_basis_train.m:17-57): shuffle the file list
    (the reference's shuffle is deliberately unseeded — pass ``rng`` for a
    reproducible campaign, the fix SURVEY §4 calls out); per file, read as
    float and scale to int16 range; strip silence (VAD) / crop to the
    annotation window / cap at train_file_len_max; normalize; append; stop
    once the sequence cap is reached (the final clip is truncated).
    """
    fs = cfg.signal.fs
    t = cfg.train
    file_cap = int(t.train_file_len_max_s * fs)
    seq_cap = int(t.train_seq_len_max_s * fs)

    files = sorted(p for p in Path(db_path).iterdir()
                   if p.suffix.lower() == ".wav")
    if shuffle:
        rng = rng or np.random.default_rng()
        files = [files[i] for i in rng.permutation(len(files))]

    # MATLAB's s_full auto-grows when a VAD/annotation clip exceeds the
    # file cap (only plain clips are hard-capped, run_basis_train.m:30-43),
    # so collect clips in a list instead of a fixed buffer
    clips: list[np.ndarray] = []
    count = 0
    used: list[Path] = []
    for f in files[:: max(t.clip_subsample, 1)]:
        s, fs_in = read_wav_normalized(f)
        if fs_in != fs:
            raise ValueError(f"{f}: fs {fs_in} != configured {fs}")
        s = s * 32767.0
        if vad:
            s = apply_vad(s, energy_vad(s, fs))
        elif t.train_anot:
            win = load_annotation(f.stem, len(s), fs, anno_dir)
            if win is not None:
                s = s[win[0]: win[1]]
            elif len(s) > file_cap:
                # missing annotation (the reference errors here; we fall
                # back) must still respect the per-file cap
                s = s[:file_cap]
        elif len(s) > file_cap:
            s = s[:file_cap]
        if len(s) == 0:
            continue
        clips.append(normalize_clip(s))
        count += len(clips[-1])
        used.append(f)
        if count > seq_cap:
            count = seq_cap
            break
    out = np.concatenate(clips)[:count] if clips else np.zeros(0)
    return out, SequenceSpec(files=used, total_samples=count)
