"""The benchmark of spamtree_tpu_torch: see run.py."""
