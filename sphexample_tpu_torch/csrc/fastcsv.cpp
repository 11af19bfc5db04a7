// CSV column reader for DualSPHysics-style particle layouts, built for the
// host (port of native/fastcsv.cpp; bound with ctypes by io/native.py).
//
// Memory-maps the file, parses the (possibly quoted / space-padded) header,
// then extracts the requested numeric columns in one pass.  A field is read
// with strtod_l in the C locale, so the decimal point is '.' whatever
// LC_NUMERIC the process runs under; strtod and Python's float() both round
// correctly, so the values are the bits of io/csv_io.py's csv-module path.
//
// The reader serves only files whose every needed field it can read as that
// path would: anything else - a short row, an empty or non-numeric field, a
// quote in a body row, a field of another grammar than [+-]digits[.digits]
// [e[+-]digits] - makes fastcsv_read_columns return -1, and the csv-module
// path then reads the file (and raises its precise error).  A line that is
// empty (or only "\r") is skipped, as the csv module skips it.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -o libfastcsv.so fastcsv.cpp
// (io/native.py does this at first use; the .cpp suffix keeps it out of the
// nvcc builds of ops/_build.py).

#include <algorithm>
#include <cctype>
#include <clocale>
#include <cstdlib>
#include <cstring>
#include <fcntl.h>
#include <locale.h>
#include <string>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>
#include <vector>

namespace {

struct Mapped {
  const char* data = nullptr;
  size_t size = 0;
  int fd = -1;

  bool open_file(const char* path) {
    fd = ::open(path, O_RDONLY);
    if (fd < 0) return false;
    struct stat st;
    if (fstat(fd, &st) != 0) return false;
    size = static_cast<size_t>(st.st_size);
    if (size == 0) return false;
    void* p = mmap(nullptr, size, PROT_READ, MAP_PRIVATE, fd, 0);
    if (p == MAP_FAILED) return false;
    data = static_cast<const char*>(p);
    return true;
  }

  ~Mapped() {
    if (data) munmap(const_cast<char*>(data), size);
    if (fd >= 0) ::close(fd);
  }
};

bool blank(char c) { return c == ' ' || c == '\t' || c == '\r'; }

// strip surrounding whitespace and quotes from a header token
std::string clean_token(const char* begin, const char* end) {
  while (begin < end && (std::isspace(static_cast<unsigned char>(*begin)) || *begin == '"'))
    ++begin;
  while (end > begin &&
         (std::isspace(static_cast<unsigned char>(end[-1])) || end[-1] == '"'))
    --end;
  return std::string(begin, end);
}

// A header token the csv module would split or unquote otherwise: a quote
// anywhere but at the two ends of the blank-trimmed token.
bool plain_header_token(const char* begin, const char* end) {
  while (begin < end && std::isspace(static_cast<unsigned char>(*begin))) ++begin;
  while (end > begin && std::isspace(static_cast<unsigned char>(end[-1]))) --end;
  if (begin < end && *begin == '"') ++begin;
  if (end > begin && end[-1] == '"') --end;
  return std::find(begin, end, '"') == end;
}

// The characters of the decimal grammar both readers accept alike.
bool numeric_char(char c) {
  return (c >= '0' && c <= '9') || c == '+' || c == '-' || c == '.' || c == 'e' ||
         c == 'E';
}

// Parse one field [begin, end) as a double; false where the csv-module path
// must decide (empty, another grammar, trailing characters).
bool parse_field(const char* begin, const char* end, locale_t c_locale, double* out) {
  while (begin < end && blank(*begin)) ++begin;
  while (end > begin && blank(end[-1])) --end;
  const size_t len = static_cast<size_t>(end - begin);
  char buf[64];
  if (len == 0 || len >= sizeof(buf)) return false;
  for (const char* c = begin; c < end; ++c)
    if (!numeric_char(*c)) return false;
  memcpy(buf, begin, len);
  buf[len] = '\0';
  char* stop = nullptr;
  *out = strtod_l(buf, &stop, c_locale);
  return stop == buf + len;
}

}  // namespace

extern "C" {

// Parse the header line; returns the number of columns, writing each cleaned
// name NUL-separated into `names_buf` (capacity `buf_len`).  -1 on error, on
// a buffer too small, or on a header the csv module would read otherwise.
int fastcsv_header(const char* path, char* names_buf, long buf_len) {
  Mapped m;
  if (!m.open_file(path)) return -1;
  const char* p = m.data;
  const char* line_end = static_cast<const char*>(memchr(p, '\n', m.size));
  if (!line_end) line_end = m.data + m.size;

  long used = 0;
  int ncols = 0;
  const char* tok = p;
  for (const char* c = p; c <= line_end; ++c) {
    if (c == line_end || *c == ',') {
      if (!plain_header_token(tok, c)) return -1;
      std::string name = clean_token(tok, c);
      long need = static_cast<long>(name.size()) + 1;
      if (used + need > buf_len) return -1;
      memcpy(names_buf + used, name.c_str(), need);
      used += need;
      ++ncols;
      tok = c + 1;
    }
  }
  return ncols;
}

// Read `ncols` columns (by 0-based index into the header order) from the CSV
// into `out` (row-major [nrows, ncols]).  Returns the number of rows parsed,
// or -1 where the csv-module path must read the file (see the top).
// `max_rows` bounds the output buffer.
long fastcsv_read_columns(const char* path, const int* col_idx, int ncols,
                          double* out, long max_rows) {
  Mapped m;
  if (!m.open_file(path)) return -1;
  const char* end = m.data + m.size;
  const char* nl = static_cast<const char*>(memchr(m.data, '\n', m.size));
  if (!nl) return 0;
  const char* p = nl + 1;
  if (memchr(p, '"', end - p)) return -1;  // quoted body fields: the csv module's

  locale_t c_locale = newlocale(LC_NUMERIC_MASK, "C", static_cast<locale_t>(0));
  if (c_locale == static_cast<locale_t>(0)) return -1;
  int max_col = 0;
  for (int k = 0; k < ncols; ++k) max_col = std::max(max_col, col_idx[k]);
  // the output slots a file column feeds (a column may be asked for twice)
  std::vector<std::vector<int>> slots(max_col + 1);
  for (int k = 0; k < ncols; ++k) slots[col_idx[k]].push_back(k);

  long nrows = 0;
  bool ok = true;
  while (ok && p < end) {
    const char* line_end = static_cast<const char*>(memchr(p, '\n', end - p));
    if (!line_end) line_end = end;
    const char* next_line = line_end < end ? line_end + 1 : end;
    if (line_end == p || (line_end == p + 1 && *p == '\r')) {  // empty line
      p = next_line;
      continue;
    }
    if (nrows >= max_rows) {
      ok = false;
      break;
    }
    double* row = out + nrows * ncols;
    int col = 0;
    const char* field = p;
    while (col <= max_col) {
      const char* comma = static_cast<const char*>(memchr(field, ',', line_end - field));
      const char* field_end = comma ? comma : line_end;
      if (!slots[col].empty()) {
        double v;
        if (!parse_field(field, field_end, c_locale, &v)) {
          ok = false;
          break;
        }
        for (int k : slots[col]) row[k] = v;
      }
      ++col;
      if (!comma) break;
      field = comma + 1;
    }
    if (ok && col <= max_col) ok = false;  // a short row
    ++nrows;
    p = next_line;
  }
  freelocale(c_locale);
  return ok ? nrows : -1;
}

// Count body lines, blank ones included: an upper bound of the rows read.
long fastcsv_count_rows(const char* path) {
  Mapped m;
  if (!m.open_file(path)) return -1;
  long lines = 0;
  const char* p = m.data;
  const char* end = m.data + m.size;
  while (p < end) {
    const char* nl = static_cast<const char*>(memchr(p, '\n', end - p));
    ++lines;
    if (!nl) break;
    p = nl + 1;
  }
  return lines > 0 ? lines - 1 : 0;  // minus header
}

}  // extern "C"
