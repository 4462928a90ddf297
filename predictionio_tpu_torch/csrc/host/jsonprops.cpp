// Columnar JSON property scanner: the host library behind the port's
// numeric-property promotion (parquet compaction). A copy of the JAX
// package's native/jsonprops.cpp with the same C ABI and the same declines.
//
// The parquet driver's promote_numeric runs over tens of millions of small
// JSON objects, where a per-row Python json.loads costs minutes. This
// kernel makes one pass over a concatenated buffer of JSON objects and
// reports, per top-level key:
//   - a per-row float64 column (NaN where the key is absent) for keys whose
//     present values are ONLY JSON numbers or booleans (the unambiguous
//     subset where C and Python coercion agree bit-for-bit), and
//   - flags: "saw_other" marks keys with null/object/array values or
//     strings provably not float()-coercible — rejected, exactly as the
//     Python path rejects them; "saw_string" marks keys with a string that
//     MIGHT coerce (e.g. "3"), which makes the Python side decline the
//     whole batch so Python's float() semantics decide.
//
// Any malformed line aborts the whole scan (returns NULL): the batch is
// declined and the caller's exact Python path runs, so this kernel can be
// strict.
//
// C ABI only, loaded with ctypes.

#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <locale.h>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct KeyInfo {
    std::string name;
    // allocated lazily on the first numeric value — rejected keys (string
    // labels etc.) must not cost nrows×8B each at 25M-row scale
    std::vector<double> column;
    int64_t last_row = -1;    // duplicate-key-in-one-object detection
    bool saw_string = false;  // a maybe-coercible string value
    bool saw_other = false;   // null/object/array/never-coercible string
};

struct Scan {
    std::vector<KeyInfo> keys;
    std::unordered_map<std::string, size_t> index;
    int64_t nrows = 0;
};

struct Cursor {
    const char* p;
    const char* end;
    bool ok = true;

    void ws() {
        while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r'))
            ++p;
    }
    bool eat(char c) {
        ws();
        if (p < end && *p == c) {
            ++p;
            return true;
        }
        ok = false;
        return false;
    }
    bool peek(char c) {
        ws();
        return p < end && *p == c;
    }
};

// Scan past a JSON string (opening quote consumed), appending the raw
// (still-escaped) contents to *out when non-null. Returns false on error.
bool skip_string(Cursor& c, std::string* out) {
    while (c.p < c.end) {
        char ch = *c.p++;
        if (ch == '"') return true;
        if (ch == '\\') {
            if (c.p >= c.end) return false;
            if (out) {
                out->push_back('\\');
                out->push_back(*c.p);
            }
            ++c.p;
            continue;
        }
        if (out) out->push_back(ch);
    }
    return false;
}

// Minimal unescape for object KEYS (values never need their text here).
// json.dumps(ensure_ascii=True) emits \uXXXX for non-ASCII; decode the BMP
// cases to UTF-8 so key names match Python's. Surrogate pairs are rare in
// keys — on encountering one, fail the scan (Python fallback handles it).
bool unescape_key(const std::string& raw, std::string& out) {
    out.clear();
    for (size_t i = 0; i < raw.size(); ++i) {
        char ch = raw[i];
        if (ch != '\\') {
            out.push_back(ch);
            continue;
        }
        if (++i >= raw.size()) return false;
        switch (raw[i]) {
            case '"': out.push_back('"'); break;
            case '\\': out.push_back('\\'); break;
            case '/': out.push_back('/'); break;
            case 'b': out.push_back('\b'); break;
            case 'f': out.push_back('\f'); break;
            case 'n': out.push_back('\n'); break;
            case 'r': out.push_back('\r'); break;
            case 't': out.push_back('\t'); break;
            case 'u': {
                if (i + 4 >= raw.size()) return false;
                unsigned cp = 0;
                for (int k = 1; k <= 4; ++k) {
                    char h = raw[i + k];
                    cp <<= 4;
                    if (h >= '0' && h <= '9') cp |= h - '0';
                    else if (h >= 'a' && h <= 'f') cp |= h - 'a' + 10;
                    else if (h >= 'A' && h <= 'F') cp |= h - 'A' + 10;
                    else return false;
                }
                i += 4;
                if (cp == 0) return false;  // NUL would truncate the C name
                if (cp >= 0xD800 && cp <= 0xDFFF) return false;  // surrogate
                if (cp < 0x80) {
                    out.push_back(static_cast<char>(cp));
                } else if (cp < 0x800) {
                    out.push_back(static_cast<char>(0xC0 | (cp >> 6)));
                    out.push_back(static_cast<char>(0x80 | (cp & 0x3F)));
                } else {
                    out.push_back(static_cast<char>(0xE0 | (cp >> 12)));
                    out.push_back(static_cast<char>(0x80 | ((cp >> 6) & 0x3F)));
                    out.push_back(static_cast<char>(0x80 | (cp & 0x3F)));
                }
                break;
            }
            default:
                return false;
        }
    }
    return true;
}

// Could this raw (escaped) string content be float()-coercible in Python?
// Conservative: any escape sequence, or any character that can appear in a
// Python float literal (digits, sign, '.', exponent, underscores, the
// letters of inf/infinity/nan, whitespace) keeps it "maybe"; one character
// outside that alphabet (most labels/categories/ids have one) proves it can
// never coerce — Python would reject the key, and so can we.
bool string_maybe_coercible(const std::string& raw) {
    if (raw.empty()) return true;  // float("") raises, but stay conservative
    for (char ch : raw) {
        if (static_cast<unsigned char>(ch) >= 0x80)
            return true;  // Python float() accepts non-ASCII digits/spaces
        if (ch == '\\') return true;  // escaped char: don't reason about it
        if ((ch >= '0' && ch <= '9') || ch == '+' || ch == '-' || ch == '.' ||
            ch == '_' || ch == ' ' || ch == '\t' || ch == '\n' || ch == '\r')
            continue;
        switch (ch) {  // i n f a t y (inf / infinity / nan), either case
            case 'i': case 'n': case 'f': case 'a': case 't': case 'y':
            case 'e': case 'E':
            case 'I': case 'N': case 'F': case 'A': case 'T': case 'Y':
                continue;
            default:
                return false;
        }
    }
    return true;
}

// Skip a JSON value of any type. When the value is a number or boolean,
// set *num and return kind 1; possibly-float-coercible string → kind 2;
// null/object/array or never-coercible string → kind 3 (key rejected,
// matching Python). Returns 0 on parse error.
int skip_value(Cursor& c, double* num) {
    c.ws();
    if (c.p >= c.end) return 0;
    char ch = *c.p;
    if (ch == '"') {
        ++c.p;
        static thread_local std::string content;
        content.clear();
        if (!skip_string(c, &content)) return 0;
        return string_maybe_coercible(content) ? 2 : 3;
    }
    if (ch == 't') {
        if (c.end - c.p >= 4 && std::memcmp(c.p, "true", 4) == 0) {
            c.p += 4;
            *num = 1.0;
            return 1;
        }
        return 0;
    }
    if (ch == 'f') {
        if (c.end - c.p >= 5 && std::memcmp(c.p, "false", 5) == 0) {
            c.p += 5;
            *num = 0.0;
            return 1;
        }
        return 0;
    }
    if (ch == 'n') {
        if (c.end - c.p >= 4 && std::memcmp(c.p, "null", 4) == 0) {
            c.p += 4;
            return 3;
        }
        return 0;
    }
    if (ch == '{' || ch == '[') {
        int depth = 0;
        while (c.p < c.end) {
            char d = *c.p++;
            if (d == '"') {
                if (!skip_string(c, nullptr)) return 0;
            } else if (d == '{' || d == '[') {
                ++depth;
            } else if (d == '}' || d == ']') {
                if (--depth == 0) return 3;
            }
        }
        return 0;
    }
    // number: validate the token against the JSON grammar FIRST — strtod
    // alone also accepts hex, 'inf', '1.' etc., forms json.loads rejects,
    // and accepting them would serve corrupted rows as data instead of
    // surfacing the error the Python path raises.
    if (ch == '-' || (ch >= '0' && ch <= '9')) {
        const char* s = c.p;
        bool is_int = true;
        if (*s == '-') ++s;
        if (s >= c.end || *s < '0' || *s > '9') return 0;
        if (*s == '0') {
            ++s;
        } else {
            while (s < c.end && *s >= '0' && *s <= '9') ++s;
        }
        if (s < c.end && *s == '.') {
            is_int = false;
            ++s;
            if (s >= c.end || *s < '0' || *s > '9') return 0;
            while (s < c.end && *s >= '0' && *s <= '9') ++s;
        }
        if (s < c.end && (*s == 'e' || *s == 'E')) {
            is_int = false;
            ++s;
            if (s < c.end && (*s == '+' || *s == '-')) ++s;
            if (s >= c.end || *s < '0' || *s > '9') return 0;
            while (s < c.end && *s >= '0' && *s <= '9') ++s;
        }
        // strtod on the validated span, pinned to the C locale — a host app
        // that setlocale()s to a ','-decimal locale must not change results
        static locale_t c_locale = newlocale(LC_ALL_MASK, "C", nullptr);
        static thread_local std::string token;
        token.assign(c.p, s);  // NUL-terminated copy of just the literal
        char* endp = nullptr;
        *num = strtod_l(token.c_str(), &endp, c_locale);
        if (endp != token.c_str() + token.size()) return 0;
        // an INTEGER literal overflowing double: json.loads gives a Python
        // int and float(int) raises OverflowError on the Python path —
        // decline rather than silently serving inf. (Float literals like
        // 1e999 become inf in BOTH paths, so those stay.)
        if (is_int && !std::isfinite(*num)) return 0;
        c.p = s;
        return 1;
    }
    return 0;
}

}  // namespace

extern "C" {

// Scan `nrows` JSON objects laid out back-to-back in buf; offsets[i] /
// offsets[i+1] delimit row i (offsets has nrows+1 entries — exactly an
// Arrow string column's layout). Returns an opaque handle, or NULL if any
// row fails to parse (caller uses its fallback).
void* pio_props_scan(const char* buf, const int64_t* offsets, int64_t nrows) {
    auto* scan = new Scan();
    scan->nrows = nrows;
    std::string raw_key, key;
    for (int64_t row = 0; row < nrows; ++row) {
        Cursor c{buf + offsets[row], buf + offsets[row + 1]};
        if (c.p == c.end) continue;  // empty cell: json path treats as {}
        // whitespace-ONLY cells are a json.loads error, not {} — decline
        if (!c.eat('{')) {
            delete scan;
            return nullptr;
        }
        if (c.peek('}')) {
            ++c.p;
            c.ws();
            if (c.p != c.end) {  // '{}garbage' is a json.loads error
                delete scan;
                return nullptr;
            }
            continue;
        }
        while (true) {
            if (!c.eat('"')) {
                delete scan;
                return nullptr;
            }
            raw_key.clear();
            if (!skip_string(c, &raw_key) || !unescape_key(raw_key, key)) {
                delete scan;
                return nullptr;
            }
            if (!c.eat(':')) {
                delete scan;
                return nullptr;
            }
            double num = 0.0;
            int kind = skip_value(c, &num);
            if (kind == 0) {
                delete scan;
                return nullptr;
            }
            auto it = scan->index.find(key);
            size_t ki;
            if (it == scan->index.end()) {
                ki = scan->keys.size();
                scan->index.emplace(key, ki);
                scan->keys.emplace_back();
                scan->keys[ki].name = key;
            } else {
                ki = it->second;
            }
            KeyInfo& info = scan->keys[ki];
            if (info.last_row == row) {
                // duplicate key in one object: json.loads keeps only the
                // LAST value; replicating that for the flags is subtle, so
                // decline — Python's semantics decide
                delete scan;
                return nullptr;
            }
            info.last_row = row;
            if (kind == 1) {
                if (!info.saw_other) {
                    if (info.column.empty())
                        info.column.assign(
                            static_cast<size_t>(nrows), std::nan(""));
                    info.column[static_cast<size_t>(row)] = num;
                }
            } else if (kind == 2) {
                info.saw_string = true;
            } else {
                info.saw_other = true;
                info.column.clear();  // rejected: release, never read again
                info.column.shrink_to_fit();
            }
            if (c.peek(',')) {
                ++c.p;
                continue;
            }
            if (c.eat('}')) break;
            delete scan;
            return nullptr;
        }
        c.ws();
        if (c.p != c.end) {  // trailing garbage in the row
            delete scan;
            return nullptr;
        }
    }
    return scan;
}

int64_t pio_props_nkeys(void* h) {
    return static_cast<int64_t>(static_cast<Scan*>(h)->keys.size());
}

const char* pio_props_key_name(void* h, int64_t i) {
    return static_cast<Scan*>(h)->keys[static_cast<size_t>(i)].name.c_str();
}

// Bit 0: saw_string (a maybe-coercible string → caller must decline),
// bit 1: saw_other (null/object/array/never-coercible string → key rejected).
int32_t pio_props_key_flags(void* h, int64_t i) {
    const KeyInfo& k = static_cast<Scan*>(h)->keys[static_cast<size_t>(i)];
    return (k.saw_string ? 1 : 0) | (k.saw_other ? 2 : 0);
}

// Pointer to the per-row float64 column for key i (length = nrows).
const double* pio_props_key_column(void* h, int64_t i) {
    return static_cast<Scan*>(h)->keys[static_cast<size_t>(i)].column.data();
}

void pio_props_free(void* h) { delete static_cast<Scan*>(h); }

}  // extern "C"
