from se_snmf_nat_tpu_torch.bnmf.enhance import (
    BnmfEnhancer, BnmfModel, BnmfParams, spectrogram, train_speech_model)
from se_snmf_nat_tpu_torch.bnmf.streaming import BnmfStreamingSession
from se_snmf_nat_tpu_torch.bnmf.vb import (
    GammaPost, clamp_min_shape, elbo, init_train, vb_h_infer, vb_train)

__all__ = [
    "BnmfEnhancer", "BnmfModel", "BnmfParams", "BnmfStreamingSession",
    "GammaPost", "clamp_min_shape", "elbo", "init_train", "spectrogram",
    "train_speech_model", "vb_h_infer", "vb_train",
]
