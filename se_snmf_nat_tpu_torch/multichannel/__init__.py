"""Multichannel path of the port: NTF channel-loading factorization and the
PMWF spectro-temporal beamformer, offline, per frame, whole-utterance and
as a push session (counterpart of the reference package's
``multichannel``; reference: src/GIST_NTF_C.m, src/kr.m, src/PSD_cov_mat.m,
src/PMWF_sep_event_RT_CHiME.m).  Plain PyTorch on the card: no kernel of
the port computes any of it."""

from se_snmf_nat_tpu_torch.multichannel.ntf import (
    khatri_rao, ntf_solve, NtfResult, ten2mat)
from se_snmf_nat_tpu_torch.multichannel.pmwf import (
    PmwfParams, PmwfEnhancer, spectro_temporal_cov, pmwf_filters)
from se_snmf_nat_tpu_torch.multichannel.streaming import (
    NtfOnlineState, NtfStreamingSession, PmwfStreamState,
    PmwfStreamingSession, make_pmwf_batch_run, make_pmwf_batch_run_fast,
    make_pmwf_stream_step, make_pmwf_streaming_run,
    make_pmwf_streaming_run_fast, pmwf_stream_init,
    pmwf_streaming_enhance,
    window_cov)

__all__ = [
    "khatri_rao", "ntf_solve", "NtfResult", "ten2mat",
    "PmwfParams", "PmwfEnhancer", "spectro_temporal_cov", "pmwf_filters",
    "NtfOnlineState", "NtfStreamingSession", "PmwfStreamState",
    "PmwfStreamingSession", "make_pmwf_batch_run",
    "make_pmwf_batch_run_fast", "make_pmwf_stream_step",
    "make_pmwf_streaming_run", "make_pmwf_streaming_run_fast",
    "pmwf_stream_init", "pmwf_streaming_enhance",
    "window_cov",
]
