"""CLIP text embedding and host-side scorer (counterpart of
laenerf_tpu/train/clip_guidance.py).

The backprop path is models/clip_vit.py's tower through
Trainer.train_one_batch_clip. The text side is encoded once per prompt by
a locally cached HuggingFace CLIP (LAENERF_CLIP_PATH, else
"openai/clip-vit-base-patch16" from the local cache; nothing is
downloaded). Without `transformers` or a cached model CLIPLoss raises
RuntimeError at construction.
"""

import os

import numpy as np
import torch


def text_embedding(text: str, model_path: str = None) -> np.ndarray:
    """The normalised [512] CLIP text embedding of a prompt (host side,
    once; gated like CLIPLoss), for Trainer.train_one_batch_clip."""
    scorer = CLIPLoss(text, model_path=model_path)
    return scorer.text_z.detach().cpu().numpy().reshape(-1)


class CLIPLoss:
    """Negative text-image cosine similarity of rendered images, scored by
    the cached HF CLIP on the host (monitoring and selection)."""

    def __init__(self, text: str, model_path: str = None):
        model_path = model_path or os.environ.get(
            "LAENERF_CLIP_PATH", "openai/clip-vit-base-patch16")
        try:
            from transformers import CLIPModel, CLIPProcessor

            self.model = CLIPModel.from_pretrained(model_path,
                                                   local_files_only=True)
            self.processor = CLIPProcessor.from_pretrained(
                model_path, local_files_only=True)
        except Exception as e:
            raise RuntimeError(
                "CLIP guidance requires a locally cached CLIP model "
                "(set LAENERF_CLIP_PATH); this environment has no network "
                "egress to download one.") from e
        with torch.no_grad():
            tok = self.processor(text=[text], return_tensors="pt",
                                 padding=True)
            z = self.model.get_text_features(**tok)
            self.text_z = z / z.norm(dim=-1, keepdim=True)

    def __call__(self, image_hw3: np.ndarray) -> float:
        """-(image_z . text_z) of a rendered [H, W, 3] image in [0, 1]."""
        with torch.no_grad():
            inp = self.processor(
                images=(np.clip(image_hw3, 0, 1) * 255).astype(np.uint8),
                return_tensors="pt")
            z = self.model.get_image_features(**inp)
            z = z / z.norm(dim=-1, keepdim=True)
            return float(-(z * self.text_z).sum())
