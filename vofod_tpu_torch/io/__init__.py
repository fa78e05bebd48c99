"""vofod_tpu_torch.io."""
