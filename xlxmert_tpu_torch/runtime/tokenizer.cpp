// Native WordPiece batch encoder: the host-side hot path of the data
// pipeline (millions of captions per pre-training epoch). The port's own
// copy of xlxmert_tpu/runtime/tokenizer.cpp, built at first use by
// xlxmert_tpu_torch/data/fast_tokenizer.py with the host C++ compiler.
//
// The reference drives HF's (Rust-backed) tokenizer from Python per
// sample (lxmert_data.py:27-41); this library batch-encodes on the host
// with threads, writing directly into the caller's int32 buffer.
//
// Scope: exact BERT-uncased semantics for ASCII text (lowercase,
// punctuation splitting, greedy longest-match wordpiece). Strings with
// non-ASCII bytes are REJECTED (return flag) and handled by the Python
// tokenizer (full Unicode NFD path): a fast-path/fallback split; COCO/VG
// captions are overwhelmingly ASCII. tests/test_torch_fast_tokenizer.py
// holds it to the Python implementation id for id.
//
// C API (ctypes):
//   void* xlt_vocab_load(const char* path);
//   void  xlt_vocab_free(void* h);
//   int   xlt_encode_batch(void* h, const char** texts, int n,
//                          int max_len, int* out, unsigned char* ok);
//     out: (n, max_len) int32, zero-padded; ok[i]=0 => caller must
//     re-encode texts[i] in Python. Returns number of fallbacks.

#include <algorithm>
#include <cctype>
#include <cstring>
#include <fstream>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

struct Vocab {
  std::unordered_map<std::string, int> map;
  int pad = 0, unk = 100, cls = 101, sep = 102;
  int max_word_chars = 100;
};

bool is_punct(unsigned char c) {
  return (c >= 33 && c <= 47) || (c >= 58 && c <= 64) ||
         (c >= 91 && c <= 96) || (c >= 123 && c <= 126);
}

// ASCII basic-tokenize: lowercase, strip controls, split whitespace and
// punctuation. Returns false if any non-ASCII byte is seen.
bool basic_tokenize(const char* text, std::vector<std::string>* out) {
  std::string cur;
  auto flush = [&]() {
    if (!cur.empty()) {
      out->push_back(cur);
      cur.clear();
    }
  };
  for (const char* p = text; *p; ++p) {
    unsigned char c = static_cast<unsigned char>(*p);
    if (c >= 0x80) return false;  // non-ASCII -> Python fallback
    if (c == 0) continue;
    if (std::isspace(c)) {
      flush();
    } else if (std::iscntrl(c)) {
      continue;
    } else if (is_punct(c)) {
      flush();
      out->push_back(std::string(1, static_cast<char>(c)));
    } else {
      cur.push_back(static_cast<char>(std::tolower(c)));
    }
  }
  flush();
  return true;
}

// Greedy longest-match wordpiece (BERT WordpieceTokenizer semantics).
void wordpiece(const Vocab& v, const std::string& word,
               std::vector<int>* ids) {
  if (static_cast<int>(word.size()) > v.max_word_chars) {
    ids->push_back(v.unk);
    return;
  }
  std::vector<int> pieces;
  size_t start = 0;
  while (start < word.size()) {
    size_t end = word.size();
    int cur_id = -1;
    while (start < end) {
      std::string sub = word.substr(start, end - start);
      if (start > 0) sub = "##" + sub;
      auto it = v.map.find(sub);
      if (it != v.map.end()) {
        cur_id = it->second;
        break;
      }
      --end;
    }
    if (cur_id < 0) {
      ids->push_back(v.unk);
      return;
    }
    pieces.push_back(cur_id);
    start = end;
  }
  ids->insert(ids->end(), pieces.begin(), pieces.end());
}

bool encode_one(const Vocab& v, const char* text, int max_len, int* out) {
  std::vector<std::string> words;
  if (!basic_tokenize(text, &words)) return false;
  std::vector<int> ids;
  ids.reserve(max_len);
  for (const auto& w : words) {
    wordpiece(v, w, &ids);
    if (static_cast<int>(ids.size()) >= max_len - 2) break;
  }
  if (static_cast<int>(ids.size()) > max_len - 2) ids.resize(max_len - 2);
  int j = 0;
  out[j++] = v.cls;
  for (int id : ids) out[j++] = id;
  out[j++] = v.sep;
  for (; j < max_len; ++j) out[j] = v.pad;
  return true;
}

}  // namespace

extern "C" {

void* xlt_vocab_load(const char* path) {
  std::ifstream f(path);
  if (!f.good()) return nullptr;
  auto* v = new Vocab();
  std::string line;
  int i = 0;
  while (std::getline(f, line)) {
    while (!line.empty() && (line.back() == '\n' || line.back() == '\r'))
      line.pop_back();
    if (!line.empty()) v->map.emplace(line, i);
    ++i;
  }
  auto get = [&](const char* tok, int dflt) {
    auto it = v->map.find(tok);
    return it == v->map.end() ? dflt : it->second;
  };
  v->pad = get("[PAD]", 0);
  v->unk = get("[UNK]", 100);
  v->cls = get("[CLS]", 101);
  v->sep = get("[SEP]", 102);
  return v;
}

void xlt_vocab_free(void* h) { delete static_cast<Vocab*>(h); }

int xlt_encode_batch(void* h, const char** texts, int n, int max_len,
                     int* out, unsigned char* ok) {
  const Vocab& v = *static_cast<Vocab*>(h);
  int n_threads = std::min<int>(std::thread::hardware_concurrency(),
                                std::max(1, n / 64));
  n_threads = std::max(1, n_threads);
  std::vector<int> fallbacks(n_threads, 0);
  auto work = [&](int t) {
    for (int i = t; i < n; i += n_threads) {
      bool good = encode_one(v, texts[i], max_len, out + i * max_len);
      ok[i] = good ? 1 : 0;
      if (!good) ++fallbacks[t];
    }
  };
  if (n_threads == 1) {
    work(0);
  } else {
    std::vector<std::thread> threads;
    for (int t = 0; t < n_threads; ++t) threads.emplace_back(work, t);
    for (auto& th : threads) th.join();
  }
  int total = 0;
  for (int f : fallbacks) total += f;
  return total;
}

}  // extern "C"
