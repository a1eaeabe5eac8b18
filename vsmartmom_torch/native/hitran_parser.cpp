// Native HITRAN .par fixed-width record parser.
//
// The framework's data-loading hot path: HITRAN line lists reach tens of
// millions of 160-char records (e.g. CO2 full list ~500k lines, CH4 ~3.8M);
// this single-pass C++ scanner parses them at memory-bandwidth speed into
// preallocated column arrays handed over from Python via ctypes
// (no per-line Python objects, no per-field str allocations).
//
// Record layout (HITRAN2004+, 19 fixed-width fields / 160 chars) matches the
// pure-Python parser in ../spectroscopy/hitran.py, which remains the
// reference implementation and fallback.
// ref: src/Absorption/read_hitran.jl:14-68 (the upstream Julia parser).

#include <cstdint>
#include <cstdlib>
#include <cstring>

namespace {

// Fixed-width field -> double; blank or malformed fields parse as 0
// (same semantics as the Python fallback's _parse_num).
double parse_f(const char* s, int w) {
    char buf[32];
    int n = w < 31 ? w : 31;
    std::memcpy(buf, s, n);
    buf[n] = '\0';
    char* end = nullptr;
    double v = std::strtod(buf, &end);
    // reject trailing garbage other than spaces (e.g. "1.2x3")
    if (end == buf) return 0.0;
    while (*end == ' ') ++end;
    if (*end != '\0') return 0.0;
    return v;
}

long parse_i(const char* s, int w) {
    char buf[32];
    int n = w < 31 ? w : 31;
    std::memcpy(buf, s, n);
    buf[n] = '\0';
    char* end = nullptr;
    long v = std::strtol(buf, &end, 10);
    if (end == buf) return 0;
    while (*end == ' ') ++end;
    if (*end != '\0') return 0;
    return v;
}

// Field start offsets (cumulative widths of the 19 fields).
constexpr int MOL = 0, ISO = 2, NU = 3, SW = 15, A = 25, GAIR = 35,
              GSELF = 40, EL = 45, NAIR = 55, DAIR = 59, STR0 = 67,
              GP = 146, GPP = 153, REC = 160;
constexpr int STRW = GP - STR0;  // 7 string fields, contiguous: 79 chars

}  // namespace

extern "C" {

// Scan `data[0:size)` (newline-delimited .par text); append records passing
// the (mol, iso, [nu_min, nu_max], min_strength) filters to the preallocated
// output columns (caller sizes them to the file's line count). `str_o`
// receives the 79 raw chars of the 7 string fields per accepted record.
// Returns the number of accepted records.
int64_t hitran_parse(const char* data, int64_t size, int mol, int iso,
                     double nu_min, double nu_max, double min_strength,
                     int32_t* mol_o, int32_t* iso_o, double* nu_o,
                     double* sw_o, double* a_o, double* gair_o,
                     double* gself_o, double* el_o, double* nair_o,
                     double* dair_o, double* gp_o, double* gpp_o,
                     char* str_o) {
    int64_t n = 0;
    const char* p = data;
    const char* endp = data + size;
    char rec[REC];
    while (p < endp) {
        const char* nl =
            static_cast<const char*>(memchr(p, '\n', endp - p));
        const char* le = nl ? nl : endp;
        int64_t len = le - p;
        if (len > 0 && p[len - 1] == '\r') --len;
        if (len > 0) {
            // Space-pad short lines so tail fields read as blank -> 0,
            // mirroring the Python parser's out-of-range slices.
            int64_t c = len < REC ? len : REC;
            std::memcpy(rec, p, c);
            if (c < REC) std::memset(rec + c, ' ', REC - c);

            long m = parse_i(rec + MOL, ISO - MOL);
            long i = parse_i(rec + ISO, NU - ISO);
            double nu = parse_f(rec + NU, SW - NU);
            double sw = parse_f(rec + SW, A - SW);
            if ((mol == -1 || m == mol) && (iso == -1 || i == iso) &&
                nu >= nu_min && nu <= nu_max && sw >= min_strength) {
                mol_o[n] = static_cast<int32_t>(m);
                iso_o[n] = static_cast<int32_t>(i);
                nu_o[n] = nu;
                sw_o[n] = sw;
                a_o[n] = parse_f(rec + A, GAIR - A);
                gair_o[n] = parse_f(rec + GAIR, GSELF - GAIR);
                gself_o[n] = parse_f(rec + GSELF, EL - GSELF);
                el_o[n] = parse_f(rec + EL, NAIR - EL);
                nair_o[n] = parse_f(rec + NAIR, DAIR - NAIR);
                dair_o[n] = parse_f(rec + DAIR, STR0 - DAIR);
                gp_o[n] = parse_f(rec + GP, GPP - GP);
                gpp_o[n] = parse_f(rec + GPP, REC - GPP);
                std::memcpy(str_o + n * STRW, rec + STR0, STRW);
                ++n;
            }
        }
        if (!nl) break;
        p = nl + 1;
    }
    return n;
}

}  // extern "C"
