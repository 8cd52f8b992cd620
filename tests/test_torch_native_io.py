"""The port's native IO path (aladin_torch/io/native.py) on the CPU: the C++
TSV reader and WordPiece tokenizer against the pure-Python ones and against
aladin_tpu's, which must all give identical arrays, and the library built
from native/*.cpp into aladin_torch/_build/ without writing under native/.
"""

import base64
import os

import numpy as np
import pytest

from aladin_tpu.data.tokenizer import BertWordPieceTokenizer as JaxTokenizer
from aladin_torch.cli.common import build_tokenizer
from aladin_torch.config import DataArgs
from aladin_torch.data.dataset import RetrievalDataset, make_synthetic_dataset
from aladin_torch.data.tokenizer import BertWordPieceTokenizer
from aladin_torch.data.tsv import TSVFile, decode_region_features, write_tsv
from aladin_torch.io import native

VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "a", "photo", "of", "the", "dog", "cat",
         "##s", "##ing", "run", "café", "big", ",", ".", "!", "number", "1", "2", "##3"]
CAPTIONS = ["A photo of the dog.", "Dogs running, a big CAT!", "number 123 cats",
            "  the\tphoto  of\na dog  ", "zebra unknown words", "", "[CLS] a [SEP] dog",
            "a café of dogs", "naïve cats — 東京 photo", "ÀÉÎ dog", "a" * 120]


@pytest.fixture
def feature_tsv(tmp_path, rng):
    path = str(tmp_path / "f.tsv")
    rows, ref = [], []
    for i in range(20):
        nb = int(rng.randint(2, 30))
        feats = rng.randn(nb, 64).astype(np.float32)
        ref.append(feats)
        rows.append([100 + i, nb, base64.b64encode(feats.tobytes()).decode()])
    write_tsv(path, rows)
    return path, ref


def test_native_matches_python(feature_tsv):
    path, ref = feature_tsv
    r = native.NativeFeatureReader(path, max_floats=64 * 64)
    assert r.num_rows() == 20
    t = TSVFile(path)
    for i in range(20):
        got = r.read_features(i)
        row = t.seek(i)
        np.testing.assert_array_equal(got, decode_region_features(row[-1], int(row[1])))
        np.testing.assert_array_equal(got, ref[i])


def test_native_builds_lineidx(feature_tsv):
    path, _ = feature_tsv
    os.remove(os.path.splitext(path)[0] + ".lineidx")
    r = native.NativeFeatureReader(path, max_floats=64 * 64)
    assert r.num_rows() == 20
    assert r.read_features(3).shape[1] == 64


def test_b64_decode_floats_roundtrip(rng):
    x = rng.randn(77).astype(np.float32)
    np.testing.assert_array_equal(native.b64_decode_floats(base64.b64encode(x.tobytes())), x)


def test_native_bad_row_errors(tmp_path):
    path = str(tmp_path / "bad.tsv")
    write_tsv(path, [[1, 2, "!!!not-base64!!!"]])
    r = native.NativeFeatureReader(path, max_floats=100)
    with pytest.raises(IOError):
        r.read_features(0)


def test_library_builds_into_the_port_and_writes_nothing_under_native():
    before = {n: os.stat(os.path.join(native.NATIVE_DIR, n)).st_mtime_ns
              for n in os.listdir(native.NATIVE_DIR)}
    path = native.build()
    assert os.path.dirname(path) == os.path.abspath(native.BUILD_DIR)
    assert os.path.basename(path).startswith("libaladin_io-") and os.path.exists(path)
    assert native.available()
    after = {n: os.stat(os.path.join(native.NATIVE_DIR, n)).st_mtime_ns
             for n in os.listdir(native.NATIVE_DIR)}
    assert after == before


def test_library_name_follows_the_sources(monkeypatch, tmp_path):
    """An edited source gets another library name: no stale build loads."""
    for name in native.SOURCES:
        with open(os.path.join(native.NATIVE_DIR, name), "rb") as f:
            (tmp_path / name).write_bytes(f.read())
    monkeypatch.setattr(native, "NATIVE_DIR", str(tmp_path))
    same = native.library_path()
    (tmp_path / native.SOURCES[1]).write_bytes((tmp_path / native.SOURCES[1]).read_bytes()
                                               + b"\n// edited\n")
    assert native.library_path() != same


@pytest.mark.parametrize("cap", [3, 8, 512])
def test_native_wordpiece_ids_equal_python(tmp_path, cap):
    """ASCII captions take the C++ tokenizer, non-ASCII ones decline to the
    Python tokenizer; both give the ids of the Python tokenizer alone and of
    aladin_tpu's tokenizer."""
    vocab_file = tmp_path / "vocab.txt"
    vocab_file.write_text("\n".join(VOCAB) + "\n", encoding="utf-8")
    fast = BertWordPieceTokenizer.from_pretrained(str(tmp_path))
    assert fast.native_enabled
    slow = BertWordPieceTokenizer(fast.vocab, do_lower_case=True)
    assert not slow.native_enabled
    ref = JaxTokenizer(fast.vocab, do_lower_case=True)
    for text in CAPTIONS:
        want = slow.encode_trunc(text, cap)
        assert want == ref.encode_trunc(text, cap), text
        assert fast.encode_trunc(text, cap) == want, text
        if text.isascii():
            assert fast._native.encode(text, cap) == want, text
        else:
            assert fast._native.encode(text, cap) is None, text


def test_synthetic_tokenizer_takes_the_native_path():
    tok = build_tokenizer(DataArgs())
    assert tok.native_enabled
    assert tok.encode_trunc("a photo of the dog number 7", 50) == \
        tok.convert_tokens_to_ids(tok.tokenize("a photo of the dog number 7"))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("native_corpus"))
    make_synthetic_dataset(root, n_images=10, feat_dim=40, max_boxes=9)
    return DataArgs(data_dir=root, img_feat_file=os.path.join(root, "features.tsv"),
                    max_seq_length=20, max_img_seq_length=8, img_feature_dim=40,
                    add_od_labels=True)


@pytest.mark.parametrize("is_train", [True, False])
def test_collate_identical_with_and_without_native_io(corpus, is_train):
    tok = build_tokenizer(corpus)
    fast = RetrievalDataset(tok, corpus, "train", is_train=is_train)
    slow = RetrievalDataset(BertWordPieceTokenizer(tok.vocab), corpus, "train",
                            is_train=is_train, use_native_io=False)
    assert fast.native_enabled and not slow.native_enabled
    order = np.random.RandomState(3).permutation(len(fast))
    for idx in np.array_split(order, 5):
        a, b = fast.collate(idx), slow.collate(idx)
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_without_a_compiler_the_python_path_runs_and_says_so(corpus, monkeypatch, tmp_path,
                                                              caplog):
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "empty_build"))
    monkeypatch.setenv("CXX", "no-such-compiler")
    native._load.cache_clear()
    try:
        with caplog.at_level("WARNING", logger="vlpretrain"):
            assert not native.available()
            tok = build_tokenizer(corpus)
            ds = RetrievalDataset(tok, corpus, "train", is_train=True)
        assert not tok.native_enabled and not ds.native_enabled
        assert sum("native IO library unavailable" in r.getMessage()
                   for r in caplog.records) == 1  # once, however many callers
        want = RetrievalDataset(BertWordPieceTokenizer(tok.vocab), corpus, "train",
                                is_train=True, use_native_io=False).collate(range(6))
        got = ds.collate(range(6))
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    finally:
        native._load.cache_clear()


def test_native_reader_and_tokenizer_from_many_threads(feature_tsv, tmp_path):
    """One reader and one tokenizer serve a pool of more threads than cores,
    as the loader's pool uses them: each thread's rows and ids are its own
    (thread-local buffers, copies handed out), with a short switch interval
    to interleave the threads often."""
    import sys
    from concurrent.futures import ThreadPoolExecutor

    path, ref = feature_tsv
    reader = native.NativeFeatureReader(path, max_floats=64 * 64)
    (tmp_path / "vocab.txt").write_text("\n".join(VOCAB) + "\n", encoding="utf-8")
    tok = native.NativeWordPiece(str(tmp_path / "vocab.txt"))
    slow = BertWordPieceTokenizer({t: i for i, t in enumerate(VOCAB)})
    ascii_caps = [c for c in CAPTIONS if c.isascii()]
    want_ids = [slow.encode_trunc(c, 512) for c in ascii_caps]

    def work(seed):
        order = np.random.RandomState(seed).permutation(len(ref))
        rows = [(i, reader.read_features(int(i))) for i in order]
        ids = [tok.encode(c) for c in ascii_caps]
        return rows, ids

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with ThreadPoolExecutor(4 * (os.cpu_count() or 1)) as pool:
            results = list(pool.map(work, range(64), timeout=120))
    finally:
        sys.setswitchinterval(old)
    assert len(results) == 64
    for rows, ids in results:
        for i, got in rows:
            np.testing.assert_array_equal(got, ref[i])
        assert ids == want_ids
