// Native batch tokenizer for the host input pipeline.
//
// Semantics mirror the Python tokenizer exactly for ASCII text
// (tokenizer.py / ref backend/tokenizer.py:41): lowercase, tokens are runs
// of [A-Za-z0-9_] or single chars from ".,!?;", everything else separates;
// unknown words map to the UNK id; output is a fixed-width int32 row plus
// the true (truncated) length. Rows containing any non-ASCII byte are
// flagged (out_ok = 0) and re-encoded by the Python fallback, which keeps
// unicode behavior bit-identical to the reference while the ~100% ASCII
// MS MARCO hot path runs native.
//
// Build: g++ -O3 -march=native -shared -fPIC -fopenmp (see native/__init__.py).

#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>

namespace {

struct Vocab {
  std::unordered_map<std::string, int32_t> word_to_id;
  int32_t unk_id;
};

inline bool is_word_char(unsigned char c) {
  return (c >= 'a' && c <= 'z') || (c >= 'A' && c <= 'Z') ||
         (c >= '0' && c <= '9') || c == '_';
}

inline bool is_punct_token(unsigned char c) {
  return c == '.' || c == ',' || c == '!' || c == '?' || c == ';';
}

inline char to_lower(unsigned char c) {
  return (c >= 'A' && c <= 'Z') ? static_cast<char>(c + 32) : static_cast<char>(c);
}

}  // namespace

extern "C" {

void* vocab_create(const char* words_blob, const int64_t* offsets,
                   const int32_t* ids, int64_t n_words, int32_t unk_id) {
  auto* vocab = new Vocab();
  vocab->unk_id = unk_id;
  vocab->word_to_id.reserve(static_cast<size_t>(n_words) * 2);
  for (int64_t i = 0; i < n_words; ++i) {
    vocab->word_to_id.emplace(
        std::string(words_blob + offsets[i],
                    static_cast<size_t>(offsets[i + 1] - offsets[i])),
        ids[i]);
  }
  return vocab;
}

void vocab_free(void* handle) { delete static_cast<Vocab*>(handle); }

int64_t vocab_size(void* handle) {
  return static_cast<int64_t>(static_cast<Vocab*>(handle)->word_to_id.size());
}

// Encode n_texts strings (concatenated in `blob`, bounds in `offsets`,
// length n_texts+1) into out_tokens [n_texts, max_len] (pre-filled by the
// caller with pad_id) and out_lengths [n_texts]. out_ok[i] = 0 marks a row
// the caller must re-encode in Python (non-ASCII byte seen).
void encode_batch(void* handle, const char* blob, const int64_t* offsets,
                  int64_t n_texts, int32_t max_len, int32_t /*pad_id*/,
                  int32_t* out_tokens, int32_t* out_lengths,
                  uint8_t* out_ok) {
  const Vocab& vocab = *static_cast<Vocab*>(handle);

#pragma omp parallel for schedule(dynamic, 64)
  for (int64_t i = 0; i < n_texts; ++i) {
    const char* begin = blob + offsets[i];
    const char* end = blob + offsets[i + 1];
    int32_t* row = out_tokens + i * max_len;
    int32_t count = 0;
    bool ascii_ok = true;
    std::string word;
    word.reserve(32);

    auto emit_word = [&]() {
      if (!word.empty() && count < max_len) {
        auto it = vocab.word_to_id.find(word);
        row[count++] = (it != vocab.word_to_id.end()) ? it->second : vocab.unk_id;
      }
      word.clear();
    };

    for (const char* p = begin; p < end && count < max_len; ++p) {
      unsigned char c = static_cast<unsigned char>(*p);
      if (c >= 0x80) {  // non-ASCII: unicode semantics -> Python fallback
        ascii_ok = false;
        break;
      }
      if (is_word_char(c)) {
        word.push_back(to_lower(c));
      } else {
        emit_word();
        if (count < max_len && is_punct_token(c)) {
          auto it = vocab.word_to_id.find(std::string(1, static_cast<char>(c)));
          row[count++] = (it != vocab.word_to_id.end()) ? it->second : vocab.unk_id;
        }
      }
    }
    if (ascii_ok) emit_word();

    out_ok[i] = ascii_ok ? 1 : 0;
    out_lengths[i] = count;
  }
}

}  // extern "C"
