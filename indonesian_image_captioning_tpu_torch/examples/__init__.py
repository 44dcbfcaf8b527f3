"""Manual-QA examples (``python -m indonesian_image_captioning_tpu_torch.examples.<name>``)."""
