"""The port's tokenizer names that the JAX package exports beside its
``Tokenizer``: ``PretrainedTokenizer`` (the reference's class name, built from
a pickled word->index map) and ``lengths_to_mask``, each held against the JAX
package's on the same pickle and lengths."""

import pickle

import numpy as np
import pytest

from twotowermlretrieval_tpu import tokenizer as jax_tok
from twotowermlretrieval_tpu_torch import tokenizer as tok

TEXTS = ["The cat sat on the mat.", "", "an unknown zebra!", "the the the cat, cat; mat?"]


@pytest.fixture
def vocab_pickle(tmp_path):
    path = tmp_path / "word_to_idx.pkl"
    with open(path, "wb") as f:
        pickle.dump({"the": 0, "cat": 1, "sat": 2, ".": 3, "mat": 4, "on": 5}, f)
    return path


def test_pretrained_tokenizer_matches_jax(vocab_pickle):
    """Same vocabulary (with <UNK> appended), ids, batches and lengths."""
    port, ref = tok.PretrainedTokenizer(vocab_pickle), jax_tok.PretrainedTokenizer(vocab_pickle)
    assert isinstance(port, tok.Tokenizer)
    assert port.word2idx == ref.word2idx and port.unk_token_id == ref.unk_token_id
    for text in TEXTS:
        assert port.encode(text) == ref.encode(text)
    for native in (False, True):
        tokens, lengths = port.encode_batch(TEXTS, max_len=5, native=native)
        r_tokens, r_lengths = ref.encode_batch(TEXTS, max_len=5)
        np.testing.assert_array_equal(tokens, r_tokens)
        np.testing.assert_array_equal(lengths, r_lengths)


@pytest.mark.parametrize("max_len", [1, 3, 6])
def test_lengths_to_mask_matches_jax(max_len):
    """Boolean [B, max_len] masks, lengths of 0, inside and past max_len,
    from a list and from an int32 array."""
    lengths = [0, 2, 3, 9]
    for given in (lengths, np.asarray(lengths, np.int32)):
        mask = tok.lengths_to_mask(given, max_len)
        want = jax_tok.lengths_to_mask(given, max_len)
        assert mask.dtype == np.bool_ and mask.shape == (4, max_len)
        np.testing.assert_array_equal(mask, want)
