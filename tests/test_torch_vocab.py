"""The port's vocabulary and keyframe database against the JAX package's, on
tests/test_vocab.py's clustered descriptors (and random ones).

Exact: the trained tree (every node's descriptor, the child table, leaves,
word ids, levels and the idf weights), the words of every descriptor, the
database's candidates and their order. BoW vectors and scores within 1e-12
(both are float64 host arithmetic in the same order). The DBoW2-YAML loader
on a small file the test writes, with entries wrapped over lines: every
array equal.
"""
import dataclasses

import numpy as np
import pytest
import torch

from multicol_slam_tpu.models import vocab as jv
from multicol_slam_tpu_torch import convert
from multicol_slam_tpu_torch.models import vocab as tv


def clustered_descs(seed=23, n_clusters=20, per_cluster=50, flip=4):
    """Descriptors grouped around cluster prototypes (test_vocab.py's)."""
    rng = np.random.default_rng(seed)
    protos = rng.integers(0, 256, size=(n_clusters, 32), dtype=np.uint8)
    out, labels = [], []
    for i, p in enumerate(protos):
        for _ in range(per_cluster):
            d = p.copy()
            for _ in range(flip):
                d[rng.integers(0, 32)] ^= np.uint8(1 << rng.integers(0, 8))
            out.append(d)
            labels.append(i)
    return np.stack(out), np.asarray(labels)


CONFIGS = [dict(k=5, depth=3, seed=0), dict(k=3, depth=2, seed=1), dict(k=9, depth=3, seed=0),
           dict(k=9, depth=3, seed=4, max_train=600)]
IDS = ["k5-L3", "k3-L2", "k9-L3", "k9-L3-subsampled"]


@pytest.fixture(scope="module")
def descs():
    return clustered_descs()[0]


def _fields(voc):
    return {f.name: getattr(voc, f.name) for f in dataclasses.fields(jv.Vocabulary)}


@pytest.fixture(scope="module", params=CONFIGS, ids=IDS)
def vocabs(request, descs):
    return (jv.build_vocabulary(descs, **request.param),
            tv.build_vocabulary(descs, **request.param, device="cpu"))


def test_build_vocabulary_trains_the_same_tree(vocabs):
    jvoc, tvoc = vocabs
    for name, a in _fields(jvoc).items():
        b = getattr(tvoc, name)
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(b, a, err_msg=name)
            assert b.dtype == a.dtype, name
        else:
            assert a == b, name
    assert tvoc.n_words == jvoc.n_words > 5


def test_transform_words_gives_the_same_words(vocabs, descs):
    jvoc, tvoc = vocabs
    rng = np.random.default_rng(1)
    noise = rng.integers(0, 256, (300, 32), dtype=np.uint8)
    for d in (descs, noise, descs[:1]):
        np.testing.assert_array_equal(tv.transform_words(tvoc, d, device="cpu"), jv.transform_words(jvoc, d))
    # a tensor keeps its own device
    np.testing.assert_array_equal(tv.transform_words(tvoc, torch.tensor(descs)), jv.transform_words(jvoc, descs))
    assert tv.transform_words(tvoc, descs[:0], device="cpu").shape == (0,)


def test_converted_vocabulary(vocabs, descs):
    """convert.vocabulary_from_numpy carries a JAX vocabulary across."""
    jvoc, _ = vocabs
    tvoc = convert.vocabulary_from_numpy(**{k: np.asarray(v) for k, v in _fields(jvoc).items()})
    np.testing.assert_array_equal(tv.transform_words(tvoc, descs, device="cpu"), jv.transform_words(jvoc, descs))


def _bows(voc_pair, descs, labels):
    jvoc, tvoc = voc_pair
    out = []
    for i in range(10):
        sel = descs[(labels == 2 * i) | (labels == 2 * i + 1)]
        out.append((jv.bow_vector(jvoc, jv.transform_words(jvoc, sel)),
                    tv.bow_vector(tvoc, tv.transform_words(tvoc, sel, device="cpu"))))
    return out


def test_bow_vectors_and_scores(vocabs):
    d, labels = clustered_descs()
    bows = _bows(vocabs, d, labels)
    for bj, bt in bows:
        assert bj.keys() == bt.keys()
        assert max(abs(bj[w] - bt[w]) for w in bj) <= 1e-12
    for (aj, at) in bows:
        for (bj, bt) in bows:
            assert abs(tv.bow_score(at, bt) - jv.bow_score(aj, bj)) <= 1e-12
    assert tv.bow_score({}, bows[0][1]) == jv.bow_score({}, bows[0][0]) == 0.0


def test_database_query_and_erase(vocabs):
    d, labels = clustered_descs()
    bows = _bows(vocabs, d, labels)
    jdb, tdb = jv.KeyFrameDatabase(vocabs[0]), tv.KeyFrameDatabase(vocabs[1])
    for i, (bj, bt) in enumerate(bows):
        jdb.add(i, bj)
        tdb.add(i, bt)
    q_desc = d[(labels == 6) | (labels == 7)][::2]
    qj = jv.bow_vector(vocabs[0], jv.transform_words(vocabs[0], q_desc))
    qt = tv.bow_vector(vocabs[1], tv.transform_words(vocabs[1], q_desc, device="cpu"))
    for exclude, min_score in ((set(), 0.0), ({3}, 0.0), (set(), 0.05)):
        rj, rt = jdb.query(qj, exclude, min_score), tdb.query(qt, exclude, min_score)
        assert [k for k, _ in rt] == [k for k, _ in rj]
        assert all(abs(a - b) <= 1e-12 for (_, a), (_, b) in zip(rt, rj))
    assert tdb.query(qt, set(), 0.0)[0][0] == 3
    for db in (jdb, tdb):
        db.erase(3)
        db.erase(3)
    assert [k for k, _ in tdb.query(qt, set(), 0.0)] == [k for k, _ in jdb.query(qj, set(), 0.0)]
    assert tdb.inverted == jdb.inverted


def _yaml_text(rng, k=3, L=2, B=32, wrap=True):
    """A small DBoW2 vocabulary in OpenCV-YAML: the root, k children, k^2
    leaves (words); node entries wrapped over two lines when `wrap`."""
    lines = ["%YAML:1.0", "---", "vocabulary:", f"   k: {k}", f"   L: {L}", "   scoringType: 0",
             "   weightingType: 0", "   nodes:"]
    nid, leaves = 1, []
    for parent in [0] + list(range(1, k + 1)):
        for _ in range(k):
            d = " ".join(str(int(x)) for x in rng.integers(0, 256, B))
            w = float(rng.uniform(0.1, 3.0)) if parent else 0.0
            head = f"      - {{ nodeId:{nid}, parentId:{parent}, weight:{w},"
            lines += [head, f'          descriptor:"{d}" }}'] if wrap else [f'{head} descriptor:"{d}" }}']
            if parent:
                leaves.append(nid)
            nid += 1
    lines.append("   words:")
    lines += [f"      - {{ wordId:{i}, nodeId:{n} }}" for i, n in enumerate(leaves)]
    return "\n".join(lines) + "\n"


@pytest.mark.parametrize("wrap", [True, False], ids=["wrapped", "one-line"])
def test_load_dbow2_yaml(tmp_path, wrap):
    path = tmp_path / "voc.yml"
    path.write_text(_yaml_text(np.random.default_rng(2), wrap=wrap))
    jvoc, tvoc = jv.load_dbow2_yaml(str(path)), tv.load_dbow2_yaml(str(path))
    for name, a in _fields(jvoc).items():
        np.testing.assert_array_equal(np.asarray(getattr(tvoc, name)), np.asarray(a), err_msg=name)
    assert tvoc.n_words == 9 and tvoc.k == 3 and tvoc.depth == 2
    d = np.random.default_rng(3).integers(0, 256, (200, 32), dtype=np.uint8)
    words = tv.transform_words(tvoc, d, device="cpu")
    np.testing.assert_array_equal(words, jv.transform_words(jvoc, d))
    assert (words >= 0).all()


def test_descend_defaults_to_the_card(descs):
    """The descent runs on the card unless asked for the CPU; without one it
    raises instead of running on the CPU."""
    import inspect

    for fn in (tv.transform_words, tv.build_vocabulary):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    voc = tv.build_vocabulary(descs, k=3, depth=2, device="cpu")
    assert voc.device_tables(torch.device("cpu"))[0].device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tv.transform_words(voc, descs)
