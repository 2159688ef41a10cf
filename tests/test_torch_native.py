"""The port's native C++ batch tokenizer against the JAX package's native
and Python paths (exact token ids and lengths), and where it builds."""

import numpy as np
import pytest

from twotowermlretrieval_tpu.tokenizer import Tokenizer as JaxTokenizer
from twotowermlretrieval_tpu_torch import native
from twotowermlretrieval_tpu_torch.ops import _build
from twotowermlretrieval_tpu_torch.tokenizer import Tokenizer

WORDS = {f"word{i}": i for i in range(1000)}
WORDS.update({"the": 1000, "cat": 1001, ".": 1002, ",": 1003, "c_d": 1004, "42": 1005})

# the JAX package's own native-tokenizer cases (tests/test_native.py)
TEXTS = [
    "The CAT, sat! on word1 word999 unknownzzz.",
    "",
    "c_d 42 ... ,,, ;;; ???",
    "word1 " * 500,  # truncation
    "punctuation-only: !?.,;",
    "naïve café résumé",  # non-ASCII -> Python fallback rows
    "mixed ascii and ünïcode words",
    "word2\tword3\nword4\r\nword5",
]


@pytest.fixture(scope="module")
def toks():
    if not native.native_available():
        pytest.skip(f"native tokenizer unavailable: {native.native_error()}")
    return Tokenizer(WORDS), JaxTokenizer(WORDS)


def _random_ascii(n=200, seed=0):
    rng = np.random.default_rng(seed)
    words = list(Tokenizer(WORDS).word2idx)
    return [" ".join(rng.choice(words, size=rng.integers(0, 40))) for _ in range(n)]


@pytest.mark.parametrize("max_len,texts", [(4, "cases"), (16, "cases"), (128, "cases"),
                                           (32, "random")])
def test_native_matches_jax_native_and_python(toks, max_len, texts):
    port, jax_tok = toks
    texts = TEXTS if texts == "cases" else _random_ascii()
    nat = port.encode_batch(texts, max_len, native=True)
    assert port._get_native_vocab() is not None  # the C++ path ran
    for other in (port.encode_batch(texts, max_len, native=False),
                  jax_tok.encode_batch(texts, max_len, native=True),
                  jax_tok.encode_batch(texts, max_len, native=False)):
        np.testing.assert_array_equal(nat[0], other[0])
        np.testing.assert_array_equal(nat[1], other[1])
    assert nat[0].dtype == np.int32 and nat[1].dtype == np.int32


def test_native_vocab_size(toks):
    port, _ = toks
    assert port._get_native_vocab().size() == port.vocab_size()


def test_library_lands_in_the_port_build_dir(toks):
    """The library is the port's own build, named by the source's hash,
    under the port's build directory, not the JAX package's cache."""
    from twotowermlretrieval_tpu.native import _CACHE_DIR as jax_cache
    from twotowermlretrieval_tpu.native import _SRC as jax_src

    path = native.library_path()
    assert path.exists() and path.parent == _build.build_dir()
    assert path.name.startswith("tokenizer_") and path.suffix == ".so"
    assert jax_cache.resolve() not in path.resolve().parents
    src = (_build.CSRC.parent / "native" / "tokenizer.cc").read_bytes()
    assert src == jax_src.read_bytes()  # a byte-for-byte copy
