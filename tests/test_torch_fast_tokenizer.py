"""The port's native WordPiece batch encoder (data/fast_tokenizer.py,
runtime/tokenizer.cpp) against the JAX package's FastTokenizer and the
port's Python Tokenizer, on tests/test_fast_tokenizer.py's vocabulary
and sentences. Ids are compared exactly (no tolerance)."""
import os
import time

import numpy as np
import pytest

from tests.test_fast_tokenizer import SENTENCES, VOCAB
from xlxmert_tpu.data.fast_tokenizer import FastTokenizer as JaxFast
from xlxmert_tpu.data.tokenization import Tokenizer as JaxTokenizer
from xlxmert_tpu_torch.data import fast_tokenizer
from xlxmert_tpu_torch.data.fast_tokenizer import FastTokenizer
from xlxmert_tpu_torch.data.tokenization import Tokenizer

RUNTIME = os.path.dirname(fast_tokenizer.SOURCE)


@pytest.fixture(scope="module")
def vocab(tmp_path_factory):
    p = tmp_path_factory.mktemp("v") / "vocab.txt"
    p.write_text("\n".join(VOCAB) + "\n")
    return str(p)


def runtime_files():
    return sorted(n for n in os.listdir(RUNTIME) if n != "__pycache__")


def test_native_ids_equal_the_jax_and_python_tokenizers(vocab):
    before = runtime_files()
    fast = FastTokenizer(vocab)
    assert fast.native, fast.build_error
    assert fast.build_error is None
    ours = fast.encode_batch(SENTENCES, 20)
    np.testing.assert_array_equal(ours, JaxFast(vocab).encode_batch(
        SENTENCES, 20))
    np.testing.assert_array_equal(ours, Tokenizer(vocab).encode_batch(
        SENTENCES, 20))
    # the non-ASCII row went through the Python path, id for id
    assert ours[-1].tolist() == Tokenizer(vocab).encode_batch(
        SENTENCES[-1:], 20)[0].tolist()
    # the library lands in _build/ under a hash of its source; nothing is
    # written beside the source
    so = fast_tokenizer.library_path()
    assert os.path.dirname(so) == fast_tokenizer.BUILD_DIR
    assert os.path.basename(so).startswith("libxlt_tokenizer-")
    assert os.path.exists(so)
    assert runtime_files() == before == ["__init__.py", "tokenizer.cpp"]


def test_failed_build_falls_back_to_python_with_the_same_ids(
        vocab, tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    monkeypatch.delenv("CXX", raising=False)
    monkeypatch.setattr(fast_tokenizer, "BUILD_DIR", str(tmp_path / "build"))
    fast = FastTokenizer(vocab)
    assert not fast.native
    assert "compiler" in fast.build_error
    assert not os.path.exists(tmp_path / "build")
    np.testing.assert_array_equal(fast.encode_batch(SENTENCES, 20),
                                  Tokenizer(vocab).encode_batch(SENTENCES,
                                                                20))
    # uncased=False: the Python tokenizer, as in the JAX package
    cased = FastTokenizer(vocab, do_lower_case=False)
    assert not cased.native and cased.build_error
    np.testing.assert_array_equal(
        cased.encode_batch(SENTENCES, 20),
        JaxFast(vocab, do_lower_case=False).encode_batch(SENTENCES, 20))


def test_native_encodes_4096_rows_faster_than_python(vocab):
    fast = FastTokenizer(vocab)
    base = ["a man running in the park with a red balloon ! " * 3] * 4096
    t0 = time.perf_counter()
    ours = fast.encode_batch(base, 20)
    t_fast = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref = fast.py.encode_batch(base, 20)
    t_py = time.perf_counter() - t0
    np.testing.assert_array_equal(ours, ref)
    assert t_fast < t_py, (t_fast, t_py)


def test_scalar_api_equals_the_jax_tokenizer(vocab):
    fast, jax_tok = FastTokenizer(vocab), JaxTokenizer(vocab)
    for tok in (fast, Tokenizer(vocab)):
        assert tok.vocab_size == jax_tok.vocab_size == len(VOCAB)
        assert tok.mask_id == jax_tok.mask_id == VOCAB.index("[MASK]")
        assert tok.ids_to_tokens == jax_tok.ids_to_tokens
        for ids in ([2, 7, 8, 9, 3], [5, 20, 21, 999], []):
            assert tok.decode(ids) == jax_tok.decode(ids)
        assert tok.encode(SENTENCES[0]) == jax_tok.encode(SENTENCES[0])
    assert fast.decode(fast.encode_batch(SENTENCES[:1], 20)[0]) \
        == jax_tok.decode(jax_tok.encode_batch(SENTENCES[:1], 20)[0])
