// fast_tokenizer — native wordpiece tokenization (C ABI, ctypes-loaded).
//
// Reference parity: PaddleNLP/faster_tokenizer's C++ core (the reference
// framework ships its text tokenization as native code; see also
// paddle/phi/kernels/strings/*).  The hot loop — basic tokenization +
// greedy longest-match-first wordpiece over a vocab hash map — runs in C++
// so the Python DataLoader workers spend their time in one native call per
// text instead of a Python inner loop per character.
//
// Build: g++ -O2 -shared -fPIC fast_tokenizer.cpp -o libfast_tokenizer.so
// (done lazily by tokenizer.py; pure-Python fallback keeps parity when no
// toolchain is present).
//
// UTF-8 handling: multi-byte sequences are kept intact and treated as word
// characters (matching BasicTokenizer's default no-CJK-split behavior for
// continuation bytes); ASCII punctuation splits, ASCII letters lowercase.

#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Tokenizer {
  std::unordered_map<std::string, int32_t> vocab;
  int32_t unk_id = 0;
  int max_chars_per_word = 100;
};

inline bool is_ascii_punct(unsigned char c) {
  return (c >= 33 && c <= 47) || (c >= 58 && c <= 64) ||
         (c >= 91 && c <= 96) || (c >= 123 && c <= 126);
}

inline bool is_space(unsigned char c) {
  return c == ' ' || c == '\t' || c == '\n' || c == '\r';
}

// Split text into basic tokens: whitespace-separated, punctuation isolated,
// optional ASCII lowercasing.  Multi-byte UTF-8 stays glued to its word.
void basic_tokenize(const char* text, bool lower,
                    std::vector<std::string>* out) {
  std::string cur;
  for (const unsigned char* p = (const unsigned char*)text; *p; ++p) {
    unsigned char c = *p;
    if (is_space(c)) {
      if (!cur.empty()) { out->push_back(cur); cur.clear(); }
    } else if (is_ascii_punct(c)) {
      if (!cur.empty()) { out->push_back(cur); cur.clear(); }
      out->push_back(std::string(1, (char)c));
    } else {
      if (lower && c >= 'A' && c <= 'Z') c += 32;
      cur.push_back((char)c);
    }
  }
  if (!cur.empty()) out->push_back(cur);
}

// Greedy longest-match-first wordpiece (BERT algorithm).
void wordpiece(const Tokenizer& t, const std::string& word,
               std::vector<int32_t>* out) {
  if ((int)word.size() > t.max_chars_per_word) {
    out->push_back(t.unk_id);
    return;
  }
  size_t start = 0;
  std::vector<int32_t> pieces;
  while (start < word.size()) {
    size_t end = word.size();
    int32_t cur_id = -1;
    while (start < end) {
      std::string sub = word.substr(start, end - start);
      if (start > 0) sub = "##" + sub;
      auto it = t.vocab.find(sub);
      if (it != t.vocab.end()) { cur_id = it->second; break; }
      --end;
    }
    if (cur_id < 0) {  // no piece matched: whole word is UNK
      out->push_back(t.unk_id);
      return;
    }
    pieces.push_back(cur_id);
    start = end;
  }
  out->insert(out->end(), pieces.begin(), pieces.end());
}

}  // namespace

extern "C" {

void* ft_create(const char** tokens, int32_t n, int32_t unk_id) {
  Tokenizer* t = new Tokenizer();
  t->vocab.reserve((size_t)n * 2);
  for (int32_t i = 0; i < n; ++i) t->vocab.emplace(tokens[i], i);
  t->unk_id = unk_id;
  return t;
}

void ft_destroy(void* handle) { delete (Tokenizer*)handle; }

// Tokenize `text` into ids; returns the count (clipped to max_out).
int32_t ft_tokenize(void* handle, const char* text, int32_t do_lower,
                    int32_t* out_ids, int32_t max_out) {
  const Tokenizer& t = *(const Tokenizer*)handle;
  std::vector<std::string> words;
  basic_tokenize(text, do_lower != 0, &words);
  std::vector<int32_t> ids;
  ids.reserve(words.size() * 2);
  for (const auto& w : words) wordpiece(t, w, &ids);
  int32_t n = (int32_t)ids.size();
  if (n > max_out) n = max_out;
  std::memcpy(out_ids, ids.data(), (size_t)n * sizeof(int32_t));
  return n;
}

}  // extern "C"
