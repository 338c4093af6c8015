"""Dictionary (basis) checkpoint I/O.

Loads the reference's pretrained MAT-file dictionaries
(basis/<class>/<conf>/R_<R>.mat holding B_DFT_sub 513xR / B_Mel_sub 64xR,
run_basis_train.m:136) and provides an .npz-based native checkpoint format
for bases trained by this framework (train/basis.py).

The port's own copy of the reference package's module of the same name,
held equal to it statement for statement by tests/test_torch_io.py.
One difference: the location of the reference's bundled dictionaries is the
caller's to give (``reference_basis_dir(root)``,
``load_reference_speech_noise(root=...)``); the port reads no fixed path.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np


@dataclass
class BasisPair:
    """A DFT-domain and mel-domain dictionary for one source class."""

    b_dft: np.ndarray  # (n_bins * (2*splice+1), R)
    b_mel: np.ndarray  # (f_order * (2*splice+1), R)

    @property
    def rank(self) -> int:
        return self.b_dft.shape[1]

    def tiled_to_rank(self, r: int) -> "BasisPair":
        """Reference behavior when a stored basis is narrower than p.R_d:
        duplicate leading columns REPEATEDLY until wide enough (the
        reference loops — filewise_run_IS16.m:39-43 — so ranks smaller than
        half the target tile multiple times, not just once)."""
        if self.rank >= r:
            return self
        b_dft, b_mel = self.b_dft, self.b_mel
        while b_dft.shape[1] < r:
            extra = min(r - b_dft.shape[1], b_dft.shape[1])
            b_dft = np.concatenate([b_dft, b_dft[:, :extra]], axis=1)
            b_mel = np.concatenate([b_mel, b_mel[:, :extra]], axis=1)
        return BasisPair(b_dft=b_dft, b_mel=b_mel)


def load_basis_mat(path: str | Path) -> BasisPair:
    """Load a reference R_<R>.mat checkpoint (MAT v5 or v7.3)."""
    import scipy.io as sio

    try:
        m = sio.loadmat(str(path))
        return BasisPair(
            b_dft=np.ascontiguousarray(m["B_DFT_sub"], dtype=np.float64),
            b_mel=np.ascontiguousarray(m["B_Mel_sub"], dtype=np.float64),
        )
    except NotImplementedError:
        # MAT v7.3 is HDF5; fall back to h5py if present.
        import h5py  # pragma: no cover

        with h5py.File(str(path), "r") as f:  # pragma: no cover
            return BasisPair(
                b_dft=np.array(f["B_DFT_sub"]).T,
                b_mel=np.array(f["B_Mel_sub"]).T,
            )


def save_basis(path: str | Path, pair: BasisPair, **extras: np.ndarray) -> None:
    """Native checkpoint (.npz): replaces the reference's save -v7.3."""
    np.savez_compressed(str(path), B_DFT_sub=pair.b_dft, B_Mel_sub=pair.b_mel,
                        **extras)


def load_basis(path: str | Path) -> BasisPair:
    """Load either a native .npz or a reference .mat, by extension."""
    p = Path(path)
    if p.suffix == ".mat":
        return load_basis_mat(p)
    with np.load(str(p)) as z:
        return BasisPair(b_dft=z["B_DFT_sub"], b_mel=z["B_Mel_sub"])


def reference_basis_dir(root: str | Path) -> Path:
    """Location of the reference's bundled pretrained dictionaries under the
    reference repository's root ``root``."""
    return Path(root) / "basis"


def load_reference_speech_noise(r_d: int = 100, *, root: str | Path
                                ) -> tuple[BasisPair, BasisPair]:
    """The two dictionaries the north-star config loads
    (filewise_run_IS16.m:24-43): TIMIT-clean speech + CHiME3-background noise,
    noise tiled up to r_d columns if narrower.  ``root``: the reference
    repository's root."""
    root = reference_basis_dir(root)
    speech = load_basis_mat(
        root / "Clean_train_TIMIT_test" / "TASLP_Splice0-SNMF_p2_DD0" / "R_100.mat")
    noise = load_basis_mat(
        root / "CHiME3_bgn_ch6" / "TASLP_Splice0-SNMF_p2_DD0" / "R_100.mat")
    return speech, noise.tiled_to_rank(r_d)
