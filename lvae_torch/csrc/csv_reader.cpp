// The data layer's CSV reader: host C++, bound with ctypes by
// utils/native_io.py and built with g++ at first use (kernels_cuda/build.py).
//
// The datasets are wide numeric CSVs (Health MNIST: 1296 pixel columns,
// 20 rows a subject). The file is memory-mapped and parsed in one pass with
// strtod, so a 20,000-row cohort reads without a Python object per field.
//
// Semantics: comma-separated numeric fields; 'nan'/'NaN' and empty fields
// read as NaN (healthy subjects' disease_time is empty in the label CSVs),
// as does a field strtod cannot parse; blanks and tabs before a field are
// skipped; '\r' before a line end is dropped; blank lines are skipped;
// `skip_header` leading lines are skipped. The column count is the first
// data row's; a row of another width makes the read fail (code 3 or 4).

#include <cmath>
#include <cstdlib>
#include <cstring>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

// A read-only mapping of a whole file, unmapped and closed on scope exit.
class Mapping {
 public:
  explicit Mapping(const char* path) {
    fd_ = ::open(path, O_RDONLY);
    if (fd_ < 0) return;
    struct stat st;
    if (fstat(fd_, &st) != 0 || st.st_size == 0) return;
    void* p = mmap(nullptr, static_cast<size_t>(st.st_size), PROT_READ, MAP_PRIVATE, fd_, 0);
    if (p == MAP_FAILED) return;
    madvise(p, static_cast<size_t>(st.st_size), MADV_SEQUENTIAL);
    begin_ = static_cast<const char*>(p);
    size_ = static_cast<size_t>(st.st_size);
  }
  ~Mapping() {
    if (begin_ != nullptr) munmap(const_cast<char*>(begin_), size_);
    if (fd_ >= 0) ::close(fd_);
  }
  Mapping(const Mapping&) = delete;
  Mapping& operator=(const Mapping&) = delete;

  bool ok() const { return begin_ != nullptr; }
  const char* begin() const { return begin_; }
  const char* end() const { return begin_ + size_; }

 private:
  int fd_ = -1;
  const char* begin_ = nullptr;
  size_t size_ = 0;
};

// Past `n` lines from p.
const char* skip_lines(const char* p, const char* end, int n) {
  for (; n > 0 && p < end; --n) {
    const char* nl = static_cast<const char*>(memchr(p, '\n', end - p));
    if (nl == nullptr) return end;
    p = nl + 1;
  }
  return p;
}

bool field_end(char c) { return c == ',' || c == '\n' || c == '\r'; }

// One field from *pp; *pp is left on the character after it.
double parse_field(const char** pp, const char* end) {
  const char* p = *pp;
  while (p < end && (*p == ' ' || *p == '\t')) ++p;
  // An empty field is NaN. This is tested before strtod, whose own skip of
  // white space would cross a line end and take the next row's first value.
  if (p >= end || field_end(*p)) {
    *pp = p;
    return NAN;
  }
  char* out = nullptr;
  double v = (*p == 'n' || *p == 'N') ? NAN : strtod(p, &out);
  if (out == nullptr || out == p) {  // nan/NaN, or not a number
    while (p < end && !field_end(*p)) ++p;
    *pp = p;
    return NAN;
  }
  *pp = out;
  return v;
}

}  // namespace

extern "C" {

// Rows and columns of the file at `path` after `skip_header` lines.
// Returns 0, or 1 (cannot open or map, or empty) or 2 (nothing after the
// header).
int lvae_csv_dims(const char* path, int skip_header, long* rows, long* cols) {
  Mapping f(path);
  if (!f.ok()) return 1;
  const char* end = f.end();
  const char* p = skip_lines(f.begin(), end, skip_header);
  if (p >= end) return 2;
  long c = 1;
  for (const char* q = p; q < end && *q != '\n'; ++q) c += (*q == ',');
  long r = 0;
  while (p < end) {
    const char* nl = static_cast<const char*>(memchr(p, '\n', end - p));
    const char* line_end = nl != nullptr ? nl : end;
    if (line_end > p && !(line_end == p + 1 && *p == '\r')) ++r;  // not a blank line
    if (nl == nullptr) break;
    p = nl + 1;
  }
  *rows = r;
  *cols = c;
  return 0;
}

// The fields of the file at `path` after `skip_header` lines, row-major
// into `out`, which holds `capacity` doubles. Returns 0, or 1 (cannot
// open), 3 (more fields than `capacity`) or 4 (fewer).
int lvae_csv_read(const char* path, int skip_header, double* out, long capacity) {
  Mapping f(path);
  if (!f.ok()) return 1;
  const char* end = f.end();
  const char* p = skip_lines(f.begin(), end, skip_header);
  long n = 0;
  while (p < end) {
    if (*p == '\n' || *p == '\r') {  // a blank line
      ++p;
      continue;
    }
    for (;;) {  // one row
      if (n >= capacity) return 3;
      out[n++] = parse_field(&p, end);
      if (p < end && *p == ',') {
        ++p;
        continue;
      }
      while (p < end && *p == '\r') ++p;
      if (p < end && *p == '\n') {
        ++p;
        break;
      }
      if (p >= end) break;
    }
  }
  return n == capacity ? 0 : 4;
}

}  // extern "C"
