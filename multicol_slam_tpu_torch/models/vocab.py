"""Visual vocabulary (BoW) and keyframe database, the DBoW2 capability (port
of `multicol_slam_tpu/models/vocab.py`).

A hierarchical binary vocabulary (k-ary tree of depth L) quantizes
descriptors to leaf words; keyframes get sparse tf-idf BoW vectors scored
with DBoW2's L1 metric; an inverted file retrieves loop and relocalization
candidates (cMultiKeyFrameDatabase.cpp:82-339).

- Training (k-majority, binary k-means) is host numpy, with the reference's
  `default_rng(seed)` draws, so the same descriptors train the same tree.
- `transform_words` descends every descriptor of every camera at once on
  the device: per level, each descriptor's children (gathered, unpacked to
  +-1) are scored by an exact integer Hamming distance and the first
  minimum wins, as `jnp.argmin` takes it. A node without children ends the
  descent there.
- BoW vectors, scores, the inverted file and the DBoW2-YAML loader are host
  Python (small and sparse), copied from the reference so that scores and
  candidate order agree to the last bit.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from multicol_slam_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from multicol_slam_tpu_torch.ops.matching import unpack_pm1


@dataclasses.dataclass
class Vocabulary:
    k: int                    # branching factor
    depth: int                # tree depth (levels below the root)
    node_desc: np.ndarray     # [n_nodes, B] uint8 cluster centres
    children: np.ndarray      # [n_nodes, k] int32 child node ids (-1 pad)
    is_leaf: np.ndarray       # [n_nodes] bool
    word_id: np.ndarray       # [n_nodes] int32 leaf -> word id (-1 otherwise)
    word_weight: np.ndarray   # [n_words] f32 idf weights
    node_level: np.ndarray    # [n_nodes] int32 depth of each node
    # the descent's tables by device, made at first use
    _tables: Dict[str, Tuple[torch.Tensor, ...]] = dataclasses.field(
        default_factory=dict, repr=False, compare=False)

    @property
    def n_words(self) -> int:
        return len(self.word_weight)

    def device_tables(self, device: torch.device):
        key = str(device)
        if key not in self._tables:
            self._tables[key] = tuple(torch.as_tensor(a, device=device)
                                      for a in (self.node_desc, self.children.astype(np.int64),
                                                self.word_id.astype(np.int64)))
        return self._tables[key]


def _kmajority(descs: np.ndarray, k: int, rng, iters: int = 8) -> Tuple[np.ndarray, np.ndarray]:
    """Binary k-means: cluster descriptors by Hamming distance with bit-
    majority centre updates. Returns (centres [k, B], assign [N])."""
    N = len(descs)
    k = min(k, N)
    centers = descs[rng.choice(N, k, replace=False)].copy()
    bits = np.unpackbits(descs, axis=1)  # [N, 8B]
    for _ in range(iters):
        cbits = np.unpackbits(centers, axis=1)
        d = (bits[:, None, :] != cbits[None, :, :]).sum(-1)
        assign = d.argmin(1)
        for c in range(k):
            sel = bits[assign == c]
            if len(sel):
                centers[c] = np.packbits((sel.mean(0) > 0.5).astype(np.uint8))
    cbits = np.unpackbits(centers, axis=1)
    d = (bits[:, None, :] != cbits[None, :, :]).sum(-1)
    return centers, d.argmin(1)


def build_vocabulary(descs: np.ndarray, k: int = 9, depth: int = 3, seed: int = 0, max_train: int = 20000,
                     device=DEFAULT_DEVICE) -> Vocabulary:
    """Hierarchical k-majority training on the host (DBoW2's create()); the
    idf weights come from the training set's words, descended on `device`."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    if len(descs) > max_train:
        descs = descs[rng.choice(len(descs), max_train, replace=False)]
    B = descs.shape[1]
    node_desc = [np.zeros(B, np.uint8)]
    children: List[List[int]] = [[]]
    levels = [0]
    stack = [(0, descs, 0)]  # (node, descriptors, level)
    while stack:
        node, d, lvl = stack.pop()
        if lvl >= depth or len(d) <= k:
            continue
        centers, assign = _kmajority(d, k, rng)
        for c in range(len(centers)):
            child = len(node_desc)
            node_desc.append(centers[c])
            children.append([])
            levels.append(lvl + 1)
            children[node].append(child)
            sub = d[assign == c]
            if len(sub):
                stack.append((child, sub, lvl + 1))
    n = len(node_desc)
    child_tab = np.full((n, k), -1, np.int32)
    for i, ch in enumerate(children):
        child_tab[i, : len(ch)] = ch
    is_leaf = (child_tab[:, 0] == -1)
    is_leaf[0] = False if n > 1 else True
    word_id = np.full(n, -1, np.int32)
    leaves = np.nonzero(is_leaf)[0]
    word_id[leaves] = np.arange(len(leaves), dtype=np.int32)
    voc = Vocabulary(k=k, depth=depth, node_desc=np.stack(node_desc), children=child_tab, is_leaf=is_leaf,
                     word_id=word_id, word_weight=np.ones(len(leaves), np.float32),
                     node_level=np.asarray(levels, np.int32))
    # idf weights from the training set
    words = transform_words(voc, descs, device=device)
    counts = np.bincount(words[words >= 0], minlength=voc.n_words).astype(np.float64)
    n_docs = max(len(descs), 1)
    idf = np.log(n_docs / np.maximum(counts, 1.0))
    voc.word_weight = np.maximum(idf, 1e-3).astype(np.float32)
    return voc


def descend(node_desc: torch.Tensor, children: torch.Tensor, word_id: torch.Tensor, descs: torch.Tensor,
            depth: int) -> torch.Tensor:
    """Word ids [N] of descriptors [N, B] uint8: `depth` levels of the tree,
    each child scored by its +-1 dot product (an exact integer in float32)."""
    q = unpack_pm1(descs)                                       # [N, 8B]
    nodes = torch.zeros(descs.shape[0], dtype=torch.int64, device=descs.device)
    for _ in range(depth):
        ch = children[nodes]                                    # [N, k]
        ch_valid = ch >= 0
        cb = unpack_pm1(node_desc[torch.clamp_min(ch, 0)])     # [N, k, 8B]
        dots = torch.einsum("nj,nkj->nk", q, cb)
        ham = torch.where(ch_valid, 0.5 * (q.shape[-1] - dots), torch.full_like(dots, float("inf")))
        nxt = torch.gather(ch, 1, torch.argmin(ham, dim=1, keepdim=True))[:, 0]
        # a node without children (a leaf) keeps the descriptor
        nodes = torch.where(ch_valid.any(dim=1), nxt, nodes)
    return word_id[nodes]


def transform_words(voc: Vocabulary, descs, device=DEFAULT_DEVICE) -> np.ndarray:
    """Quantize descriptors [N, B] uint8 (numpy, or a tensor, which keeps its
    device) to word ids [N] int32 (-1 if unmapped), one descent on the
    device for all of them."""
    if len(descs) == 0:
        return np.empty(0, np.int32)
    descs = descs if torch.is_tensor(descs) else torch.as_tensor(np.ascontiguousarray(descs),
                                                                  device=resolve_device(device))
    nd, ch, wid = voc.device_tables(descs.device)
    return descend(nd, ch, wid, descs, voc.depth).cpu().numpy().astype(np.int32)


def bow_vector(voc: Vocabulary, words: np.ndarray) -> Dict[int, float]:
    """tf-idf, L1-normalized sparse BoW (DBoW2 TemplatedVocabulary::transform
    with L1_NORM, TemplatedVocabulary.h:135-153, :470-474)."""
    words = words[words >= 0]
    if len(words) == 0:
        return {}
    counts = np.bincount(words, minlength=voc.n_words).astype(np.float64)
    v = counts * voc.word_weight
    s = v.sum()
    if s <= 0:
        return {}
    nz = np.nonzero(v)[0]
    return {int(w): float(v[w] / s) for w in nz}


def bow_score(v1: Dict[int, float], v2: Dict[int, float]) -> float:
    """DBoW2 L1 score 1 - 0.5 |v1/|v1| - v2/|v2||_1 in [0, 1] (higher = more
    similar)."""
    if not v1 or not v2:
        return 0.0
    common = set(v1) & set(v2)
    s = sum(abs(v1[w] - v2[w]) - abs(v1[w]) - abs(v2[w]) for w in common)
    s += sum(abs(x) for x in v1.values()) + sum(abs(x) for x in v2.values())
    return 1.0 - 0.5 * s


class KeyFrameDatabase:
    """BoW inverted file over keyframes (cMultiKeyFrameDatabase.{h,cpp})."""

    def __init__(self, voc: Vocabulary):
        self.voc = voc
        self.inverted: Dict[int, List[int]] = {}
        self.kf_bow: Dict[int, Dict[int, float]] = {}

    def add(self, kf_id: int, bow: Dict[int, float]):
        self.kf_bow[kf_id] = bow
        for w in bow:
            self.inverted.setdefault(w, []).append(kf_id)

    def erase(self, kf_id: int):
        bow = self.kf_bow.pop(kf_id, {})
        for w in bow:
            lst = self.inverted.get(w, [])
            if kf_id in lst:
                lst.remove(kf_id)

    def query(self, bow: Dict[int, float], exclude: set, min_score: float) -> List[Tuple[int, float]]:
        """Candidates by the reference's shared-word protocol
        (DetectLoopCandidates, cMultiKeyFrameDatabase.cpp:82-221): count the
        shared words, keep > 0.8 x the most, then score; best first. The
        caller pools the scores over covisibility groups."""
        shared: Dict[int, int] = {}
        for w in bow:
            for kf in self.inverted.get(w, []):
                if kf not in exclude:
                    shared[kf] = shared.get(kf, 0) + 1
        if not shared:
            return []
        min_common = 0.8 * max(shared.values())
        out = []
        for kf, n in shared.items():
            if n > min_common:
                s = bow_score(bow, self.kf_bow.get(kf, {}))
                if s >= min_score:
                    out.append((kf, s))
        out.sort(key=lambda x: -x[1])
        return out


_ENTRY_RE = re.compile(r'(\w+):\s*("[^"]*"|[^,}]+)')


def load_dbow2_yaml(path: str) -> Vocabulary:
    """Parse an OpenCV-YAML DBoW2 vocabulary (vocabulary: {k, L, nodes:
    [{nodeId, parentId, weight, descriptor}], words: [{wordId, nodeId}]}) with
    a line parser (the files are many MB; no YAML library)."""
    k = depth = 0
    nodes: Dict[int, Tuple[int, float, np.ndarray]] = {}
    words: Dict[int, int] = {}

    def parse_entry(text: str):
        cur: Dict[str, str] = {}
        for m in _ENTRY_RE.finditer(text):
            cur[m.group(1)] = m.group(2).strip().strip('"')
        if "descriptor" in cur or ("nodeId" in cur and "parentId" in cur):
            nodes[int(cur["nodeId"])] = (
                int(cur.get("parentId", -1)),
                float(cur.get("weight", 0.0)),
                np.asarray([int(x) for x in cur.get("descriptor", "").split()], np.uint8),
            )
        elif "wordId" in cur:
            words[int(cur["wordId"])] = int(cur["nodeId"])

    # OpenCV YAML wraps an entry over lines (`- { ...,\n  descriptor:"..." }`,
    # as small_orb_omni_voc_9_6.yml does for every node): gather from `- {`
    # to the closing `}` before parsing
    with open(path) as f:
        entry: Optional[str] = None
        for line in f:
            ls = line.strip()
            if entry is not None:
                entry += " " + ls
                if "}" in ls:
                    parse_entry(entry)
                    entry = None
                continue
            if ls.startswith("k:"):
                k = int(ls.split(":")[1])
            elif ls.startswith("L:"):
                depth = int(ls.split(":")[1])
            elif ls.startswith("- {"):
                if "}" in ls:
                    parse_entry(ls)
                else:
                    entry = ls
    n = max(nodes) + 2 if nodes else 1
    B = len(next(iter(nodes.values()))[2]) if nodes else 32
    node_desc = np.zeros((n, B), np.uint8)
    children_map: Dict[int, List[int]] = {}
    for nid, (parent, _, d) in nodes.items():
        if len(d) == B:
            node_desc[nid] = d
        children_map.setdefault(parent, []).append(nid)
    child_tab = np.full((n, k or 10), -1, np.int32)
    for p, ch in children_map.items():
        if 0 <= p < n:
            child_tab[p, : min(len(ch), child_tab.shape[1])] = ch[: child_tab.shape[1]]
    is_leaf = child_tab[:, 0] == -1
    word_id = np.full(n, -1, np.int32)
    weights = np.zeros(max(words) + 1 if words else 1, np.float32)
    for wid, nid in words.items():
        word_id[nid] = wid
        weights[wid] = nodes[nid][1] if nid in nodes else 1.0
    return Vocabulary(k=k or 10, depth=depth or 6, node_desc=node_desc, children=child_tab, is_leaf=is_leaf,
                      word_id=word_id, word_weight=np.maximum(weights, 1e-6), node_level=np.zeros(n, np.int32))
