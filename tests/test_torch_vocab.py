"""The port's BoW vocabulary and keyframe database against the reference:
`tests/test_database.py`'s query cases and `test_loop_solvers.py::TestBow`,
run through both packages on the same inputs, the shipped vocabulary, and
the session-trained vocabulary (k-medians with the reference's draws, the
descriptor reservoir, and a session that trains its own)."""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam2_tpu.vocab import bow as jbow
from orbslam2_tpu.vocab.database import KeyFrameDatabase as JDatabase
from orbslam2_tpu.vocab.database import _query as jquery
from orbslam2_tpu.pipeline import loop_closing as jlc
from orbslam2_tpu_torch import convert
from orbslam2_tpu_torch.pipeline import loop_closing as tlc
from orbslam2_tpu_torch.vocab import bow as tbow
from orbslam2_tpu_torch.vocab.database import KeyFrameDatabase as TDatabase
from orbslam2_tpu_torch.vocab.database import _query as tquery

REPO = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")


def t(x):
    return convert.to_tensor(x, CPU)


def t_codebook(cb):
    if isinstance(cb, jbow.Codebook):
        return tbow.Codebook(coarse=t(cb.coarse), fine=t(cb.fine))
    return t(cb)


def builtin():
    z = np.load(REPO / "orbslam2_tpu" / "data" / "vocab.npz")
    return jbow.Codebook(coarse=jnp.asarray(z["coarse"]), fine=jnp.asarray(z["fine"])), z["idf"]


# -- the database query (tests/test_database.py) ---------------------------


def _setup(K=16, V=8):
    return np.zeros((K, V), np.float32), np.zeros(K, bool), np.zeros((K, K), np.int32)


def _both(vectors, present, covis, vec, exclude=None, min_score=0.0):
    """The candidates of the reference's and the port's `_query`."""
    K = vectors.shape[0]
    exclude = np.zeros(K, bool) if exclude is None else exclude
    jc, jm, js = jquery(jnp.asarray(vectors), jnp.asarray(present), jnp.asarray(vec),
                        jnp.asarray(exclude), jnp.float32(min_score), jnp.asarray(covis), 8)
    tc, tm, ts = tquery(t(vectors), t(present), t(vec), t(exclude), min_score, t(covis), 8)
    ref = [int(c) for c, m in zip(np.asarray(jc), np.asarray(jm)) if m]
    got = [int(c) for c, m in zip(tc.tolist(), tm.tolist()) if m]
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6)
    assert got == ref, (got, ref)
    return got, ts.numpy()


def test_group_accumulation_beats_lone_high_scorer():
    vectors, present, covis = _setup()
    vec = np.zeros(8, np.float32)
    vec[0] = 1.0
    vectors[3] = [0.8, 0.2, 0, 0, 0, 0, 0, 0]
    vectors[5] = [0.55, 0.45, 0, 0, 0, 0, 0, 0]
    vectors[6] = [0.60, 0.40, 0, 0, 0, 0, 0, 0]
    vectors[7] = [0.55, 0.45, 0, 0, 0, 0, 0, 0]
    present[[3, 5, 6, 7]] = True
    for a in (5, 6, 7):
        for b in (5, 6, 7):
            if a != b:
                covis[a, b] = 30
    cands, scores = _both(vectors, present, covis, vec)
    assert scores[3] > scores[6] > scores[5]
    assert cands[0] == 6 and cands.count(6) == 1


def test_group_uses_only_top10_covisibles():
    vectors, present, covis = _setup(K=32)
    vec = np.zeros(8, np.float32)
    vec[0] = 1.0
    vectors[1] = [0.5, 0.5, 0, 0, 0, 0, 0, 0]
    present[1] = True
    for n in range(2, 13):
        vectors[n] = [0.1, 0.9, 0, 0, 0, 0, 0, 0]
        present[n] = True
        covis[1, n] = 100 - n
    vectors[12] = [1.0, 0, 0, 0, 0, 0, 0, 0]
    vectors[20] = [0.9, 0.1, 0, 0, 0, 0, 0, 0]
    present[20] = True
    cands, scores = _both(vectors, present, covis, vec)
    assert scores[12] == 1.0
    assert cands == [1]


def test_exclusion_and_min_score_gates():
    vectors, present, covis = _setup()
    vec = np.zeros(8, np.float32)
    vec[0] = 1.0
    vectors[2] = [1.0, 0, 0, 0, 0, 0, 0, 0]
    vectors[4] = [0.9, 0.1, 0, 0, 0, 0, 0, 0]
    present[[2, 4]] = True
    exclude = np.zeros(16, bool)
    exclude[2] = True
    cands, _ = _both(vectors, present, covis, vec, exclude=exclude)
    assert 2 not in cands and 4 in cands
    cands, _ = _both(vectors, present, covis, vec, min_score=0.95)
    assert cands == [2]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_query_candidates_exact_on_random_databases(seed):
    """Random sparse databases with covisibility ties: the same candidates
    in the same order (ties by the lower index first, as `lax.top_k` and
    `argsort` order them)."""
    rng = np.random.default_rng(seed)
    K, V = 48, 64
    vectors = rng.random((K, V)).astype(np.float32) * (rng.random((K, V)) < 0.2)
    vectors /= np.maximum(vectors.sum(1, keepdims=True), 1e-9)
    present = rng.random(K) < 0.8
    covis = rng.integers(0, 4, (K, K)).astype(np.int32) * 10
    covis = np.triu(covis, 1) + np.triu(covis, 1).T
    exclude = rng.random(K) < 0.1
    _both(vectors, present, covis, vectors[0] * 0.5 + vectors[1] * 0.5, exclude=exclude,
          min_score=0.02)


# -- vocabulary and vectors (test_loop_solvers.py::TestBow) ----------------


def test_codebook_and_vectors(rng):
    descs = rng.integers(0, 2**32, (512, 8), dtype=np.uint32)
    cb = jbow.train_codebook(jnp.asarray(descs), jnp.ones(512, bool), jax.random.PRNGKey(0),
                             vocab_size=64, iters=4)
    v = tbow.bow_vector(t(descs[:100]), torch.ones(100, dtype=torch.bool), t_codebook(cb))
    assert v.shape == (64,)
    assert float(torch.sum(v)) == pytest.approx(1.0, abs=1e-5)
    ref = jbow.bow_vector(jnp.asarray(descs[:100]), jnp.ones(100, bool), cb)
    np.testing.assert_allclose(v.numpy(), np.asarray(ref), atol=1e-6)


def test_same_image_scores_high(rng):
    base = rng.integers(0, 2**32, (2048, 8), dtype=np.uint32)
    cb = t_codebook(jbow.train_codebook(jnp.asarray(base), jnp.ones(2048, bool),
                                        jax.random.PRNGKey(1), vocab_size=128, iters=4))
    ones = torch.ones(300, dtype=torch.bool)
    va = tbow.bow_vector(t(base[:300]), ones, cb)
    vb = tbow.bow_vector(t(base[:300] ^ rng.integers(0, 2, (300, 8)).astype(np.uint32)), ones, cb)
    vc = tbow.bow_vector(t(base[1000:1300]), ones, cb)
    s_same, s_diff = float(tbow.l1_score(va, vb)), float(tbow.l1_score(va, vc))
    assert s_same > s_diff + 0.2, (s_same, s_diff)


def test_database_query_excludes_covisibles(rng):
    base = rng.integers(0, 2**32, (4096, 8), dtype=np.uint32)
    jcb = jbow.train_codebook(jnp.asarray(base), jnp.ones(4096, bool), jax.random.PRNGKey(2),
                              vocab_size=128, iters=4)
    jdb, tdb = JDatabase(jcb, max_keyframes=8), TDatabase(t_codebook(jcb), max_keyframes=8)
    for k in range(6):
        lo = 0 if k in (0, 5) else 400 * k
        jdb.add(k, jnp.asarray(base[lo:lo + 300]), jnp.ones(300, bool))
        tdb.add(k, t(base[lo:lo + 300]), torch.ones(300, dtype=torch.bool))
    np.testing.assert_allclose(tdb.vectors.numpy(), np.asarray(jdb.vectors), atol=1e-6)
    covis = torch.zeros((8, 8), dtype=torch.int32)
    exclude = torch.zeros(8, dtype=torch.bool)
    exclude[5] = True
    cand, mask, _ = tdb.query(tdb.vectors[5], exclude, 0.05, covis)
    assert 0 in set(cand[mask].tolist())
    exclude[0] = True
    cand, mask, _ = tdb.query(tdb.vectors[5], exclude, 0.05, covis)
    assert 0 not in set(cand[mask].tolist())


def test_two_level_codebook_assignments_match(rng):
    """A reference-trained two-level codebook: the same word per
    descriptor, the same vector, a database row that scores itself 1."""
    centers = rng.integers(0, 2**32, (40, 8), dtype=np.uint32)
    descs = np.repeat(centers, 64, axis=0)
    for _ in range(6):
        word = rng.integers(0, 8, len(descs))
        bit = rng.integers(0, 32, len(descs)).astype(np.uint32)
        descs[np.arange(len(descs)), word] ^= (np.uint32(1) << bit).astype(np.uint32)
    jcb = jbow.train_codebook2(jnp.asarray(descs), jnp.ones(len(descs), bool),
                               jax.random.PRNGKey(0), coarse_size=16, fine_size=16, iters=4,
                               bucket_cap=512)
    cb = t_codebook(jcb)
    assert tbow.num_words(cb) == 256
    ids = tbow.word_ids(t(descs), cb)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jbow.word_ids(jnp.asarray(descs), jcb)))
    db = TDatabase(cb, max_keyframes=8)
    v = db.add(0, t(descs[:400]), torch.ones(400, dtype=torch.bool))
    _, _, scores = db.query(v, torch.zeros(8, dtype=torch.bool), 0.0,
                            torch.zeros((8, 8), dtype=torch.int32))
    assert float(scores[0]) > 0.99


# -- the shipped vocabulary -----------------------------------------------


def test_builtin_vocabulary_copy_is_byte_equal():
    ref = (REPO / "orbslam2_tpu" / "data" / "vocab.npz").read_bytes()
    assert (REPO / "orbslam2_tpu_torch" / "data" / "vocab.npz").read_bytes() == ref


@pytest.mark.parametrize("idf", [False, True], ids=["tf", "tf_idf"])
def test_builtin_vocabulary_vectors_match(rng, idf):
    """ORB descriptors of a synthetic frame and random ones: word ids
    exact, vectors within 1e-6, with and without the shipped idf."""
    from orbslam2_tpu.config import CameraConfig, OrbConfig
    from orbslam2_tpu.io import synthetic
    from orbslam2_tpu.ops import orb

    jcb, idf_np = builtin()
    cam = CameraConfig(fx=240.0, fy=240.0, cx=159.5, cy=119.5, width=320, height=240)
    img, _ = synthetic.textured_sequence(n_frames=1, kind="forward", cam=cam).frame(0)
    feats = orb.extract(jnp.asarray(img), OrbConfig(num_features=300, feature_slots=320))
    orb_descs, orb_valid = np.asarray(feats.desc), np.asarray(feats.valid)
    descs = np.concatenate([orb_descs, rng.integers(0, 2**32, (200, 8), dtype=np.uint32)])
    valid = np.concatenate([orb_valid, rng.random(200) < 0.9])
    idf_j = jnp.asarray(idf_np) if idf else None
    idf_t = t(idf_np) if idf else None
    cb = t_codebook(jcb)
    np.testing.assert_array_equal(tbow.word_ids(t(descs), cb).numpy(),
                                  np.asarray(jbow.word_ids(jnp.asarray(descs), jcb)))
    got = tbow.bow_vector(t(descs), t(valid), cb, idf_t).numpy()
    ref = np.asarray(jbow.bow_vector(jnp.asarray(descs), jnp.asarray(valid), jcb, idf_j))
    assert valid.sum() > 300
    np.testing.assert_allclose(got, ref, atol=1e-6)


def test_bow_rows_match():
    """`_bow_rows` of a [K, S] keyframe table (absent rows zero) on the
    shipped vocabulary with idf, against the reference's row map."""
    rng = np.random.default_rng(5)
    jcb, idf_np = builtin()
    K, S = 6, 128
    desc = rng.integers(0, 2**32, (K, S, 8), dtype=np.uint32)
    valid = rng.random((K, S)) < 0.8
    present = np.array([True, False, True, True, False, True])
    ref = np.asarray(jlc._bow_rows(jnp.asarray(desc), jnp.asarray(valid), jnp.asarray(present),
                                   jcb, jnp.asarray(idf_np)))
    got = tlc._bow_rows(t(desc), t(valid), t(present), t_codebook(jcb), t(idf_np)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6)
    assert not got[~present].any()


# -- the session-trained vocabulary ----------------------------------------


def ref_seeds(key, valid, vocab_size, iters):
    """The reference's k-medians draws for `key`: the initial centres,
    then each iteration's reseeds (`jax.random.fold_in(key, k)`)."""
    valid = np.asarray(valid)
    N, nv = valid.shape[0], int(valid.sum())
    p = (jnp.asarray(valid, jnp.float32) / nv) if nv else jnp.full((N,), 1.0 / N, jnp.float32)
    keys = [key] + [jax.random.fold_in(key, k) for k in range(iters)]
    return t(np.stack([np.asarray(jax.random.choice(k, N, shape=(vocab_size,), replace=True, p=p))
                       for k in keys]))


@pytest.mark.parametrize("some_invalid", [False, True])
def test_train_codebook_matches_reference(rng, some_invalid):
    """Binary k-medians with the reference's draws: the same codebook,
    word for word (clustered descriptors, so clusters empty and reseed)."""
    centers = rng.integers(0, 2**32, (24, 8), dtype=np.uint32)
    descs = np.repeat(centers, 20, axis=0)
    flips = (rng.random(descs.shape + (32,)) < 0.03).astype(np.uint32) << np.arange(32, dtype=np.uint32)
    descs ^= flips.sum(-1, dtype=np.uint32)
    valid = rng.random(len(descs)) < (0.8 if some_invalid else 1.0)
    key = jax.random.PRNGKey(3)
    ref = jbow.train_codebook(jnp.asarray(descs), jnp.asarray(valid), key, vocab_size=64, iters=5)
    got = tbow.train_codebook(t(descs), t(valid), ref_seeds(key, valid, 64, 5), 64, 5)
    np.testing.assert_array_equal(convert.to_numpy(got, descriptor=True), np.asarray(ref))


def test_train_codebook2_matches_reference(rng):
    """The two-level training with the reference's draws (the coarse key,
    then `fold_in(key, cell)` for each cell's fine run): the same coarse
    and fine words."""
    centers = rng.integers(0, 2**32, (40, 8), dtype=np.uint32)
    descs = np.repeat(centers, 32, axis=0)
    for _ in range(6):
        word = rng.integers(0, 8, len(descs))
        bit = rng.integers(0, 32, len(descs)).astype(np.uint32)
        descs[np.arange(len(descs)), word] ^= (np.uint32(1) << bit).astype(np.uint32)
    valid = np.ones(len(descs), bool)
    key = jax.random.PRNGKey(0)
    ref = jbow.train_codebook2(jnp.asarray(descs), jnp.asarray(valid), key, coarse_size=16,
                               fine_size=16, iters=3, bucket_cap=256)

    def draw(mask, size, cell):
        return ref_seeds(key if cell < 0 else jax.random.fold_in(key, cell), mask.numpy(), size, 3)

    got = tbow.train_codebook2(t(descs), t(valid), draw, coarse_size=16, fine_size=16, iters=3,
                               bucket_cap=256)
    np.testing.assert_array_equal(convert.to_numpy(got.coarse, True), np.asarray(ref.coarse))
    np.testing.assert_array_equal(convert.to_numpy(got.fine, True), np.asarray(ref.fine))


def test_descriptor_reservoir_matches_reference(rng):
    """The same uniform sample from the same stream (the reference's numpy
    sampler and seed), past the capacity."""
    ref, got = jlc.DescriptorReservoir(cap=300, seed=4), tlc.DescriptorReservoir(cap=300, seed=4)
    for _ in range(5):
        d = rng.integers(0, 2**32, (128, 8), dtype=np.uint32)
        v = rng.random(128) < 0.9
        ref.add(d, v)
        got.add_deferred(t(d), t(v))
    for a, b in zip(ref.sample(), got.sample()):
        np.testing.assert_array_equal(a, b)
    assert got.n == ref.n == 300 and got.n_seen == ref.n_seen


def test_session_trained_vocabulary_matches_reference(monkeypatch):
    """The 320x240 dolly without a vocabulary file, in both packages: the
    codebook bootstrapped on the first mapped keyframe and retrained at
    the second (the reservoir's two keyframes) is the reference's word
    for word, and so are the database rows, when the port draws what the
    reference draws (each generator's seed names the reference's key)."""
    from orbslam2_tpu.pipeline.system import System as JSystem
    from orbslam2_tpu_torch.pipeline.system import System as TSystem
    from tests.test_torch_mapping_slice import CFG, N_FRAMES, _run
    from tests.torch_config import port_config
    from orbslam2_tpu.io import synthetic

    cfg = CFG.replace(vocab=dataclasses.replace(CFG.vocab, vocab_file=None))
    seq = synthetic.textured_sequence(n_frames=N_FRAMES, kind="forward", cam=cfg.camera)
    monkeypatch.setattr(tbow, "draw_codebook_seeds", lambda valid, size, iters, generator: ref_seeds(
        jax.random.PRNGKey(generator.initial_seed()), valid.numpy(), size, iters))
    ref = JSystem(cfg)
    port = TSystem(port_config(cfg), device="cpu")
    _run(ref, seq)
    _run(port, seq)
    jl, tl = ref.loop_closer, port.loop_closer
    assert not tl.frozen_vocab and tl.idf is None and tl._kf_count == jl._kf_count == 2
    np.testing.assert_array_equal(convert.to_numpy(tl.codebook, True), np.asarray(jl.codebook))
    np.testing.assert_array_equal(tl.db.present.numpy(), np.asarray(jl.db.present))
    np.testing.assert_allclose(tl.db.vectors.numpy(), np.asarray(jl.db.vectors), atol=1e-6)
