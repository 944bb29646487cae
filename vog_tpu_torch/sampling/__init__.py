from vog_tpu_torch.sampling.conc import (
    assemble_batch,
    frame_ids,
    scores_to_canonical,
    video_ids,
    view_dims,
)

__all__ = [
    "assemble_batch",
    "frame_ids",
    "scores_to_canonical",
    "video_ids",
    "view_dims",
]
