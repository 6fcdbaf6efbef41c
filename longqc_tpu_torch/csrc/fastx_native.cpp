// Native FASTA/FASTQ(.gz) record reader of longqc_tpu_torch's host I/O.
//
// A buffered lexer in the spirit of the reference's kseq-based readers
// (written from scratch): zlib-transparent input, batch extraction into
// flat arenas (names/seqs/quals + offsets) consumed zero-copy-ish by
// the Python wrapper (io/native.py) via ctypes. io/native.py compiles
// this file with g++ into build/fastx/ on first use; it is not a kernel
// and stays out of the *.cu sources of ops/_ext.
//
// C ABI:
//   void*  lqf_open(const char* path);
//   long   lqf_next_batch(void* h, long max_records, long max_bases);
//   const char* lqf_names(void* h);  const long* lqf_name_offs(void* h);
//   const char* lqf_seqs(void* h);   const long* lqf_seq_offs(void* h);
//   const char* lqf_quals(void* h);  // empty when FASTA
//   int    lqf_has_qual(void* h);
//   void   lqf_close(void* h);

#include <zlib.h>

#include <cctype>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Reader {
  gzFile fp = nullptr;
  std::vector<char> buf = std::vector<char>(1 << 22);
  size_t pos = 0, end = 0;
  bool eof = false;

  // batch arenas
  std::string names, seqs, quals;
  std::vector<long> name_offs, seq_offs;
  bool has_qual = false;

  bool refill() {
    if (eof) return false;
    int n = gzread(fp, buf.data(), (unsigned)buf.size());
    if (n <= 0) {
      eof = true;
      return false;
    }
    pos = 0;
    end = (size_t)n;
    return true;
  }

  int getc_() {
    if (pos >= end && !refill()) return -1;
    return (unsigned char)buf[pos++];
  }

  int peek_() {
    if (pos >= end && !refill()) return -1;
    return (unsigned char)buf[pos];
  }

  // append the rest of the line to out without its newline and without
  // any '\r'; false when the input ended before any character
  bool append_line(std::string* out) {
    if (pos >= end && !refill()) return false;
    while (true) {
      const char* p = buf.data() + pos;
      const char* nl = (const char*)memchr(p, '\n', end - pos);
      const size_t n = nl ? (size_t)(nl - p) : end - pos;
      const char* cr = (const char*)memchr(p, '\r', n);
      if (!cr) {
        out->append(p, n);
      } else {
        for (size_t i = 0; i < n; ++i)
          if (p[i] != '\r') out->push_back(p[i]);
      }
      pos += n;
      if (nl) {
        ++pos;
        return true;
      }
      if (!refill()) return true;
    }
  }

  // read until newline into out (newline consumed, not stored)
  bool getline_(std::string* out) {
    out->clear();
    return append_line(out);
  }
};

}  // namespace

extern "C" {

void* lqf_open(const char* path) {
  gzFile fp = gzopen(path, "rb");
  if (!fp) return nullptr;
  Reader* r = new Reader();
  r->fp = fp;
  return r;
}

void lqf_close(void* h) {
  Reader* r = (Reader*)h;
  if (!r) return;
  gzclose(r->fp);
  delete r;
}

// Returns number of records read (0 at EOF, -1 on parse error).
long lqf_next_batch(void* h, long max_records, long max_bases) {
  Reader* r = (Reader*)h;
  r->names.clear();
  r->seqs.clear();
  r->quals.clear();
  r->name_offs.assign(1, 0);
  r->seq_offs.assign(1, 0);
  r->has_qual = false;

  long n = 0;
  long bases = 0;
  std::string line;
  while (n < max_records && bases < max_bases) {
    int c = r->getc_();
    while (c == '\n' || c == '\r') c = r->getc_();
    if (c < 0) break;
    if (c != '>' && c != '@') return -1;
    bool fastq = (c == '@');
    if (!r->getline_(&line)) return -1;
    // name = first whitespace-delimited token
    size_t ws = line.find_first_of(" \t");
    r->names.append(line, 0, ws == std::string::npos ? line.size() : ws);
    r->name_offs.push_back((long)r->names.size());

    size_t seq_start = r->seqs.size();
    if (fastq) {
      if (!r->append_line(&r->seqs)) return -1;
      int p = r->getc_();  // '+' line
      if (p != '+') return -1;
      r->getline_(&line);
      size_t want = r->seqs.size() - seq_start;
      size_t qual_start = r->quals.size();
      // quality can wrap lines in pathological files; read exactly want
      while (r->quals.size() - qual_start < want) {
        if (!r->append_line(&r->quals)) return -1;
      }
      r->has_qual = true;
    } else {
      // multi-line FASTA: sequence lines until the next '>' or EOF
      while (true) {
        const int c2 = r->peek_();
        if (c2 < 0 || c2 == '>') break;
        r->append_line(&r->seqs);
      }
    }
    r->seq_offs.push_back((long)r->seqs.size());
    bases += (long)(r->seqs.size() - seq_start);
    ++n;
  }
  return n;
}

const char* lqf_names(void* h) { return ((Reader*)h)->names.c_str(); }
const long* lqf_name_offs(void* h) { return ((Reader*)h)->name_offs.data(); }
const char* lqf_seqs(void* h) { return ((Reader*)h)->seqs.c_str(); }
const long* lqf_seq_offs(void* h) { return ((Reader*)h)->seq_offs.data(); }
const char* lqf_quals(void* h) { return ((Reader*)h)->quals.c_str(); }
int lqf_has_qual(void* h) { return ((Reader*)h)->has_qual ? 1 : 0; }

}  // extern "C"
