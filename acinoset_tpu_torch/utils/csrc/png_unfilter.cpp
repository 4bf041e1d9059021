// Undo the PNG scanline filters that depend on the byte just decoded to
// the left: 3 (Average) and 4 (Paeth), in place, one row at a time
// (PNG specification, section 9). Filters 0-2 are undone in numpy
// (acinoset_tpu_torch/utils/png.py).
#include <cstdint>
#include <cstdlib>

extern "C" {

// row: the n filtered bytes of one scanline, replaced by the raw bytes.
// prev: the previous scanline's raw bytes (zeros for the first row).
// bpp: bytes a pixel. Returns 0, or -1 for a filter other than 3 or 4.
int png_unfilter_row(int filter, uint8_t *row, const uint8_t *prev, int n, int bpp) {
  if (filter == 3) {
    for (int i = 0; i < n; ++i) {
      const int left = i >= bpp ? row[i - bpp] : 0;
      row[i] = static_cast<uint8_t>(row[i] + ((left + prev[i]) >> 1));
    }
    return 0;
  }
  if (filter == 4) {
    for (int i = 0; i < n; ++i) {
      const int a = i >= bpp ? row[i - bpp] : 0;  // left
      const int b = prev[i];                      // up
      const int c = i >= bpp ? prev[i - bpp] : 0; // up-left
      const int p = a + b - c;
      const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
      const int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
      row[i] = static_cast<uint8_t>(row[i] + pred);
    }
    return 0;
  }
  return -1;
}

}  // extern "C"
