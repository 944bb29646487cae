from vog_tpu_torch.model.grounding import MODELS, ImgGrnd, VidGrnd, VOGNet, get_model

__all__ = ["MODELS", "ImgGrnd", "VidGrnd", "VOGNet", "get_model"]
