"""The JAX package's RANSAC draws, handed to the port's samplers, so that
both systems try the same hypotheses (tests/test_torch_system.py,
tests/test_torch_cli_parity.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from multicol_slam_tpu.ops.ransac import sample_indices
from multicol_slam_tpu.slam.local_mapping import _bucket


class JaxDraws:
    """The JAX system's RANSAC draws for the port: a bootstrap attempt splits
    the system key (system.py:391) and camera c draws from fold_in(sub, c);
    relocalization draws from fold_in(key, frame_id) over the padded rows."""

    def __init__(self, seed):
        self.key = jax.random.PRNGKey(seed)
        self.attempts = {}

    def init(self, frame_id, cam, n):
        if frame_id not in self.attempts:
            self.key, self.attempts[frame_id] = jax.random.split(self.key)
        idx = sample_indices(jax.random.fold_in(self.attempts[frame_id], cam), 256, 8, n)
        return torch.tensor(np.asarray(idx))

    def reloc(self, frame_id, n):
        pS = _bucket(n, 64)
        w = (np.arange(pS) < n).astype(np.float32)
        idx = sample_indices(jax.random.fold_in(self.key, frame_id), 160, 6, pS, weights=jnp.asarray(w / n))
        return torch.tensor(np.asarray(idx))
