// Host-side group fill: packs one step's windows into the device transfer
// buffer exactly as engine/device_engine.fill_group_py does (which remains
// as the no-compiler fallback and the equality oracle in
// tests/test_groupfill.py).
//
// Per window, one row of `words` int32: r_pad bytes, one per position /
// anti-diagonal row,
//   bits 0-2  ref base   (0..5; 0 beyond the window's ref)
//   bits 3-5  seq base   (0..5; 0 beyond the window's seq)
//   bit  6    D step of row t (1 - the step in prefix-I counts)
// then the scalars b_rows n_ins n_del ref_guard seq_guard (engine/prepass.py).

#include <cstdint>

extern "C" int32_t fill_group(
    int64_t n_win, int64_t r_pad, int64_t words,
    const uint64_t* ref_ptrs, const int64_t* ref_lens,
    const uint64_t* seq_ptrs, const int64_t* seq_lens,
    const uint64_t* inss_ptrs,
    const int32_t* scal5,        // (n_win, 5): b_rows n_ins n_del rg sg
    int32_t* buf) {              // (B, words), zeroed
    int32_t max_rows = 1;

    for (int64_t j = 0; j < n_win; ++j) {
        const int8_t* ref = reinterpret_cast<const int8_t*>(ref_ptrs[j]);
        const int8_t* seq = reinterpret_cast<const int8_t*>(seq_ptrs[j]);
        const int32_t* inss = reinterpret_cast<const int32_t*>(inss_ptrs[j]);
        const int64_t ref_len = ref_lens[j];
        const int64_t seq_len = seq_lens[j];
        const int32_t b_rows = scal5[j * 5 + 0];
        if (b_rows > max_rows) max_rows = b_rows;

        int32_t* w = buf + j * words;
        uint8_t* row = reinterpret_cast<uint8_t*>(w);
        for (int64_t p = 0; p < r_pad; ++p) {
            uint8_t v = 0;
            if (p < ref_len) v = static_cast<uint8_t>(ref[p]) & 7u;
            if (p < seq_len)
                v |= (static_cast<uint8_t>(seq[p]) & 7u) << 3;
            if (p >= 1 && p < b_rows)
                v |= static_cast<uint8_t>(1 - (inss[p] - inss[p - 1])) << 6;
            row[p] = v;
        }
        int32_t* scal = w + r_pad / 4;
        for (int k = 0; k < 5; ++k) scal[k] = scal5[j * 5 + k];
    }
    return max_rows;
}
