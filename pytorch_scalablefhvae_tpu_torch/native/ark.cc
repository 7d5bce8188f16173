// Native Kaldi-archive bulk reader.
//
// The host input pipeline packs a whole split's features into one contiguous
// array (data/feature_store.py). For kaldi-format datasets that means parsing
// hundreds of thousands of binary ark records; this reader does the scan +
// copy in C++ in a single sequential pass (the Python fallback in
// utils/kaldi_ark.py parses record-by-record). Format: see utils/kaldi_ark.py.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Header {
  char dtype;  // 'F' or 'D'
  int32_t rows, cols;
  int64_t marker_pos;  // byte offset of the \0B marker (the rxspecifier
                       // offset ArkWriter records in the scp)
};

// Reads "key \0B<FM|DM> \4rows\4cols". Returns 1 on success, 0 on clean
// EOF (stream ends exactly at a key start), -1 on a malformed header —
// the caller MUST distinguish: treating corruption as EOF would silently
// truncate the archive to its valid prefix with a success return.
int read_record_header(FILE* f, std::string* key, Header* h) {
  key->clear();
  int c;
  while ((c = std::fgetc(f)) != EOF && c != ' ') key->push_back(static_cast<char>(c));
  if (c == EOF) return key->empty() ? 0 : -1;  // mid-key EOF is corruption
  h->marker_pos = std::ftell(f);
  char marker[2];
  if (std::fread(marker, 1, 2, f) != 2 || marker[0] != '\0' || marker[1] != 'B') return -1;
  char token[3];
  if (std::fread(token, 1, 3, f) != 3) return -1;
  // non-FM/DM tokens (e.g. compressed 'CM') are unsupported, not EOF
  if (token[2] != ' ' || (token[0] != 'F' && token[0] != 'D') || token[1] != 'M') return -1;
  h->dtype = token[0];
  unsigned char size_marker;
  if (std::fread(&size_marker, 1, 1, f) != 1 || size_marker != 4) return -1;
  if (std::fread(&h->rows, 4, 1, f) != 1) return -1;
  if (std::fread(&size_marker, 1, 1, f) != 1 || size_marker != 4) return -1;
  if (std::fread(&h->cols, 4, 1, f) != 1) return -1;
  if (h->rows < 0 || h->cols <= 0) return -1;
  return 1;
}

}  // namespace

extern "C" {

// Pass 1: count records / total rows / (uniform) cols. Returns 0 on success,
// negative on malformed input (-4: corrupt/unsupported record header) or
// inconsistent widths.
int ark_scan(const char* path, int64_t* n_mats, int64_t* total_rows, int32_t* cols) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  *n_mats = 0;
  *total_rows = 0;
  *cols = -1;
  std::string key;
  Header h;
  int rc;
  while ((rc = read_record_header(f, &key, &h)) == 1) {
    if (*cols == -1) *cols = h.cols;
    if (h.cols != *cols) { std::fclose(f); return -2; }
    *n_mats += 1;
    *total_rows += h.rows;
    long bytes = static_cast<long>(h.rows) * h.cols * (h.dtype == 'F' ? 4 : 8);
    if (std::fseek(f, bytes, SEEK_CUR) != 0) { std::fclose(f); return -3; }
  }
  std::fclose(f);
  return rc < 0 ? -4 : 0;
}

// Pass 2: copy every record into `data` (row-major float32, concatenated),
// fill `row_offsets` (max_mats + 1 entries), `file_offsets` (max_mats
// entries: each record's \0B-marker byte offset — the rxspecifier offset,
// letting callers match records against the scp's authoritative bindings;
// may be null) and newline-joined keys. `max_mats`/`max_rows` are the
// caller's buffer capacities from the sizing pass (ark_scan): the file can
// GROW between the two passes (an appending re-extraction), and writing
// past the capacities would silently corrupt the caller's heap — exceeding
// them returns -5 instead. `expected_cols` is the sizing pass's uniform
// width: the data buffer is allocated max_rows x expected_cols, so a
// record that comes back WIDER (the archive atomically replaced by a
// re-extraction with more mel bins — same record/row counts, so the
// mats/rows guards never fire) would overrun every row it writes; a
// mismatch returns -2. Returns number of records read, or negative on
// error (-2: record width differs from the sizing pass; -4: corrupt or
// unsupported record header mid-archive; -5: archive larger than the
// sizing pass saw).
int64_t ark_read_packed(const char* path, float* data, int64_t* row_offsets,
                        int64_t* file_offsets,
                        char* keys_out, int64_t keys_cap,
                        int64_t max_mats, int64_t max_rows,
                        int32_t expected_cols) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  std::string key;
  Header h;
  int64_t n = 0, row = 0, keys_len = 0;
  std::vector<double> dbuf;
  row_offsets[0] = 0;
  int rc;
  while ((rc = read_record_header(f, &key, &h)) == 1) {
    if (h.cols != expected_cols) { std::fclose(f); return -2; }
    if (n >= max_mats || row + h.rows > max_rows) { std::fclose(f); return -5; }
    int64_t count = static_cast<int64_t>(h.rows) * h.cols;
    float* dst = data + row * h.cols;
    if (h.dtype == 'F') {
      if (std::fread(dst, 4, count, f) != static_cast<size_t>(count)) { std::fclose(f); return -3; }
    } else {
      dbuf.resize(count);
      if (std::fread(dbuf.data(), 8, count, f) != static_cast<size_t>(count)) { std::fclose(f); return -3; }
      for (int64_t i = 0; i < count; ++i) dst[i] = static_cast<float>(dbuf[i]);
    }
    if (file_offsets) file_offsets[n] = h.marker_pos;
    row += h.rows;
    ++n;
    row_offsets[n] = row;
    int64_t need = static_cast<int64_t>(key.size()) + 1;
    if (keys_len + need < keys_cap) {
      std::memcpy(keys_out + keys_len, key.data(), key.size());
      keys_out[keys_len + key.size()] = '\n';
      keys_len += need;
    }
  }
  if (keys_len < keys_cap) keys_out[keys_len] = '\0';
  std::fclose(f);
  return rc < 0 ? -4 : n;
}

}  // extern "C"
