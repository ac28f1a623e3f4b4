"""Seeded mdBRIEF stability masks for oracle features (tests/test_torch_
masked_matching.py, tests/test_torch_masked_system.py): each landmark of a
synthetic world gets one mask, and a frame's feature takes the mask of the
landmark whose descriptor it carries (a feature's descriptor is its
landmark's with two bits flipped, so the nearest landmark descriptor names
it). The same arrays go to both packages."""
import numpy as np

FIELDS = ("uv", "response", "octave", "angle", "rays", "desc", "dmask", "valid")
_POPCOUNT = np.array([bin(i).count("1") for i in range(256)], np.uint8)


def landmark_masks(world, seed: int, keep: float = 0.85) -> np.ndarray:
    """[P, B] uint8: each bit of each landmark's mask set with probability
    `keep`."""
    P, B = world.descs.shape
    bits = np.random.default_rng(seed).random((P, 8 * B)) < keep
    return np.packbits(bits, axis=-1, bitorder="little")


def masked_fields(feats, world, masks: np.ndarray) -> dict:
    """The feature fields (numpy) of a JAX FrameFeatures with `dmask` taken
    from the features' landmarks; padded rows keep 0xFF."""
    f = {k: np.asarray(getattr(feats, k)) for k in FIELDS}
    C, K, B = f["desc"].shape
    desc = f["desc"].reshape(C * K, B)
    ham = np.stack([_POPCOUNT[desc ^ d].sum(-1, dtype=np.int32) for d in world.descs], axis=1)   # [CK, P]
    dmask = masks[ham.argmin(1)].reshape(C, K, B)
    f["dmask"] = np.where(f["valid"][..., None], dmask, np.uint8(255)).astype(np.uint8)
    return f
