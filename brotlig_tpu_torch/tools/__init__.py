"""Stage profiles of the port's decode and encode paths
(python -m brotlig_tpu_torch.tools.profile_decode / profile_encode)."""
