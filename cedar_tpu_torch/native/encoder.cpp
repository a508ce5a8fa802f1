// Native SAR fast path: raw SubjectAccessReview JSON -> feature codes.
//
// This is the serving plane's host-side hot loop in C++: it fuses the work
// of the Python pipeline (server/http.py get_authorizer_attributes ->
// server/authorizer.py record_to_cedar_resource -> compiler/table.py
// encode_request_codes) into one pass over the raw request bytes, producing
// the [n_slots] dictionary-code vector + extras list the device kernel
// consumes. Behavior parity with the Python path is enforced by
// tests/test_torch_native.py (randomized differential tests).
//
// Designed for allocation-free steady state: the JSON DOM is pointer-linked
// nodes bump-allocated from a reusable arena, string values are views into
// the request buffer (escaped strings — rare in SARs — are materialized
// into arena-owned storage), and hash-map probe keys are composed into
// reused scratch buffers.
//
// Reference behaviors mirrored (cites are to the upstream project):
//   * SAR -> attributes: internal/server/server.go:163-309
//   * principal typing + group parents: internal/server/entities/user.go:35
//   * action/resource/non-resource/impersonation entities:
//     internal/server/authorizer/entitiy_builders.go:13-143
//   * authorizer gates (self-allow, system:* skip):
//     internal/server/authorizer/authorizer.go:38-57
//
// The activation-table blob is serialized by cedar_tpu_torch/native/__init__.py
// (format documented there); canonical value-key strings must stay in sync
// with _canon() on the Python side.

#ifdef CEDAR_PY_GLUE
// Python.h first, per CPython convention. The *_pylist entries take the
// bodies list directly (via ctypes py_object through a PyDLL view of this
// library), eliminating the python-side join/fromiter/cumsum packing
// pass. No libpython link is needed
// inside a CPython process; note the PyList_GET_* macros compile to
// struct-offset reads for the BUILD interpreter's ABI, which is why
// build.py keys the .so cache on the interpreter ABI tag (SOABI).
#define PY_SSIZE_T_CLEAN
#include <Python.h>
// Python.h drags in unistd.h, whose access(2) F_OK macro would shadow the
// encoder's own F_OK flag enum below
#undef F_OK
#endif

#include <arpa/inet.h>

#include <algorithm>
#include <atomic>
#include <charconv>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <functional>
#include <memory>
#include <mutex>
#include <string>
#include <string_view>
#include <thread>
#include <unordered_map>
#include <utility>
#include <vector>

namespace {

using sv = std::string_view;

// ----------------------------------------------------------- tiny JSON DOM

struct JVal {
  enum Kind : uint8_t { NUL, BOOL, NUM, STR, ARR, OBJ } kind = NUL;
  bool b = false;
  sv str;        // STR payload
  sv key;        // member key when this node is an object member
  JVal *child = nullptr;  // first child (ARR/OBJ)
  JVal *next = nullptr;   // next sibling

  const JVal *get(sv k) const {
    if (kind != OBJ) return nullptr;
    // duplicate keys resolve to the last one, matching Python json.loads
    const JVal *found = nullptr;
    for (const JVal *c = child; c; c = c->next)
      if (c->key == k) found = c;
    return found;
  }
};

// Bump allocator with stable addresses, reusable across requests.
class Arena {
 public:
  JVal *alloc() {
    if (used_ == kChunk * chunks_.size()) chunks_.emplace_back(new JVal[kChunk]);
    JVal *v = &chunks_[used_ / kChunk][used_ % kChunk];
    ++used_;
    *v = JVal{};
    return v;
  }
  // arena-owned storage for escaped strings. Deque, NOT vector: growth must
  // never relocate the string objects — short strings store their bytes
  // inline (SSO), so a vector reallocation would dangle every sv previously
  // returned for a short escaped string (two escaped labels in one document
  // were enough to corrupt the first one's view).
  sv own(std::string &&s) {
    if (n_owned_ == owned_.size()) owned_.emplace_back();
    std::string &slot = owned_[n_owned_++];
    slot = std::move(s);
    return sv(slot);
  }
  void reset() {
    used_ = 0;
    n_owned_ = 0;
  }

 private:
  static constexpr size_t kChunk = 128;
  std::vector<std::unique_ptr<JVal[]>> chunks_;
  std::deque<std::string> owned_;
  size_t used_ = 0, n_owned_ = 0;
};

// bytes that continue the in-string fast scan (not quote, not backslash,
// not a raw control char — see JsonParser::string); constexpr so the
// per-byte hot loop carries no init guard
struct PlainTable {
  bool t[256] = {};
  constexpr PlainTable() {
    for (int c = 0; c < 256; ++c)
      t[c] = c >= 0x20 && c != '"' && c != '\\';
  }
};
constexpr PlainTable kPlain{};

class JsonParser {
 public:
  JsonParser(const char *p, size_t n, Arena &arena)
      : p_(p), end_(p + n), arena_(arena) {}

  JVal *parse() {
    JVal *v = value();
    if (!v) return nullptr;
    ws();
    if (p_ != end_) return nullptr;  // trailing garbage
    return v;
  }

 private:
  const char *p_, *end_;
  Arena &arena_;

  void ws() {
    while (p_ < end_ && (*p_ == ' ' || *p_ == '\t' || *p_ == '\n' || *p_ == '\r'))
      ++p_;
  }
  bool lit(const char *s, size_t n) {
    if (size_t(end_ - p_) < n || memcmp(p_, s, n) != 0) return false;
    p_ += n;
    return true;
  }

  JVal *value() {
    ws();
    if (p_ >= end_) return nullptr;
    switch (*p_) {
      case '{': return container(true);
      case '[': return container(false);
      case '"': {
        JVal *v = arena_.alloc();
        v->kind = JVal::STR;
        if (!string(v->str)) return nullptr;
        return v;
      }
      case 't': {
        if (!lit("true", 4)) return nullptr;
        JVal *v = arena_.alloc();
        v->kind = JVal::BOOL;
        v->b = true;
        return v;
      }
      case 'f': {
        if (!lit("false", 5)) return nullptr;
        JVal *v = arena_.alloc();
        v->kind = JVal::BOOL;
        return v;
      }
      case 'n': {
        if (!lit("null", 4)) return nullptr;
        return arena_.alloc();
      }
      default: return number();
    }
  }

  JVal *number() {
    const char *start = p_;
    if (p_ < end_ && *p_ == '-') ++p_;
    if (p_ >= end_ || *p_ < '0' || *p_ > '9') return nullptr;
    while (p_ < end_ && ((*p_ >= '0' && *p_ <= '9') || *p_ == '.' || *p_ == 'e' ||
                         *p_ == 'E' || *p_ == '+' || *p_ == '-'))
      ++p_;
    JVal *v = arena_.alloc();
    v->kind = JVal::NUM;
    v->str = sv(start, size_t(p_ - start));  // token kept for the admission walk
    return v;
  }

  static void utf8_append(std::string &out, uint32_t cp) {
    if (cp < 0x80) {
      out.push_back(char(cp));
    } else if (cp < 0x800) {
      out.push_back(char(0xC0 | (cp >> 6)));
      out.push_back(char(0x80 | (cp & 0x3F)));
    } else if (cp < 0x10000) {
      out.push_back(char(0xE0 | (cp >> 12)));
      out.push_back(char(0x80 | ((cp >> 6) & 0x3F)));
      out.push_back(char(0x80 | (cp & 0x3F)));
    } else {
      out.push_back(char(0xF0 | (cp >> 18)));
      out.push_back(char(0x80 | ((cp >> 12) & 0x3F)));
      out.push_back(char(0x80 | ((cp >> 6) & 0x3F)));
      out.push_back(char(0x80 | (cp & 0x3F)));
    }
  }

  bool hex4(uint32_t &out) {
    if (end_ - p_ < 4) return false;
    out = 0;
    for (int i = 0; i < 4; ++i) {
      char c = *p_++;
      out <<= 4;
      if (c >= '0' && c <= '9') out |= uint32_t(c - '0');
      else if (c >= 'a' && c <= 'f') out |= uint32_t(c - 'a' + 10);
      else if (c >= 'A' && c <= 'F') out |= uint32_t(c - 'A' + 10);
      else return false;
    }
    return true;
  }

  // Fast path: no escapes -> a view into the input buffer, zero copies.
  // Raw control characters (< 0x20) inside strings are a parse error,
  // like the Python lane's strict json (a decision must never depend on
  // which lane a row takes — see utf8_valid). The scan stops on quote,
  // backslash, or control char via one load per byte from the constexpr
  // kPlain table (defined at namespace scope; zero init guards here).
  bool string(sv &out) {
    ++p_;  // opening quote
    const char *start = p_;
    while (p_ < end_ && kPlain.t[uint8_t(*p_)]) ++p_;
    if (p_ >= end_ || uint8_t(*p_) < 0x20) return false;
    if (*p_ == '"') {
      out = sv(start, size_t(p_ - start));
      ++p_;
      return true;
    }
    // slow path: materialize with escape processing
    std::string buf(start, size_t(p_ - start));
    while (p_ < end_) {
      char c = *p_;
      if (c == '"') {
        ++p_;
        out = arena_.own(std::move(buf));
        return true;
      }
      if (c == '\\') {
        ++p_;
        if (p_ >= end_) return false;
        char e = *p_++;
        switch (e) {
          case '"': buf.push_back('"'); break;
          case '\\': buf.push_back('\\'); break;
          case '/': buf.push_back('/'); break;
          case 'b': buf.push_back('\b'); break;
          case 'f': buf.push_back('\f'); break;
          case 'n': buf.push_back('\n'); break;
          case 'r': buf.push_back('\r'); break;
          case 't': buf.push_back('\t'); break;
          case 'u': {
            uint32_t cp;
            if (!hex4(cp)) return false;
            if (cp >= 0xD800 && cp <= 0xDBFF && end_ - p_ >= 6 && p_[0] == '\\' &&
                p_[1] == 'u') {
              const char *save = p_;
              p_ += 2;
              uint32_t lo;
              if (!hex4(lo)) return false;
              if (lo >= 0xDC00 && lo <= 0xDFFF) {
                cp = 0x10000 + ((cp - 0xD800) << 10) + (lo - 0xDC00);
              } else {
                p_ = save;  // lone high surrogate; encode as-is (WTF-8)
              }
            }
            utf8_append(buf, cp);
            break;
          }
          default: return false;
        }
      } else {
        if (uint8_t(c) < 0x20) return false;  // raw control char in string
        buf.push_back(c);
        ++p_;
      }
    }
    return false;  // unterminated
  }

  // Nesting cap: a hostile body of 1MB of '[' would otherwise recurse once
  // per byte and overflow the native stack (no RecursionError here — the
  // whole webhook process would segfault). Beyond the cap the parse fails,
  // the row gets F_PARSE_ERROR, and the caller falls back to the Python
  // path, whose json.loads raises a handled RecursionError.
  static constexpr int kMaxDepth = 256;
  int depth_ = 0;

  JVal *container(bool is_obj) {
    if (depth_ >= kMaxDepth) return nullptr;
    ++depth_;
    JVal *v = container_body(is_obj);
    --depth_;
    return v;
  }

  JVal *container_body(bool is_obj) {
    ++p_;  // '{' or '['
    JVal *v = arena_.alloc();
    v->kind = is_obj ? JVal::OBJ : JVal::ARR;
    char close = is_obj ? '}' : ']';
    ws();
    if (p_ < end_ && *p_ == close) {
      ++p_;
      return v;
    }
    JVal *tail = nullptr;
    while (true) {
      sv key;
      if (is_obj) {
        ws();
        if (p_ >= end_ || *p_ != '"' || !string(key)) return nullptr;
        ws();
        if (p_ >= end_ || *p_ != ':') return nullptr;
        ++p_;
      }
      JVal *mv = value();
      if (!mv) return nullptr;
      mv->key = key;
      if (tail) tail->next = mv;
      else v->child = mv;
      tail = mv;
      ws();
      if (p_ < end_ && *p_ == ',') {
        ++p_;
        continue;
      }
      if (p_ < end_ && *p_ == close) {
        ++p_;
        return v;
      }
      return nullptr;
    }
  }
};

// --------------------------------------------------------- encoder tables

struct LikeComp {
  bool wild;
  std::string s;
};

struct LikeTest {
  int32_t lit;
  std::vector<LikeComp> comps;
};

struct CmpTest {
  int32_t lit;
  uint8_t op;  // 0 '<', 1 '<=', 2 '>', 3 '>='
  int64_t c;
};

// string hash usable for string_view probes without key construction
struct SvHash {
  using is_transparent = void;
  size_t operator()(sv s) const { return std::hash<sv>{}(s); }
  size_t operator()(const std::string &s) const { return std::hash<sv>{}(s); }
};
struct SvEq {
  using is_transparent = void;
  bool operator()(sv a, sv b) const { return a == b; }
};

template <class V>
using SvMap = std::unordered_map<std::string, V, SvHash, SvEq>;

template <class V>
const V *sv_find(const SvMap<V> &m, sv key) {
#if defined(__cpp_lib_generic_unordered_lookup) && \
    __cpp_lib_generic_unordered_lookup >= 201811L
  auto it = m.find(key);
#else
  thread_local std::string scratch;
  scratch.assign(key.data(), key.size());
  auto it = m.find(scratch);
#endif
  return it == m.end() ? nullptr : &it->second;
}

// dyn template node (compiler/dyn.py): the probe value of a
// <slot>.contains(<template>) / <slot> == <template> hard expression,
// resolved per request.
struct Tmpl {
  uint8_t kind;     // 0 const canon, 2 record, 3 set,
                    // 4 slot (another request slot's value)
  uint8_t var = 0;  // slot: 0 principal, 1 action, 2 resource, 3 context
  std::string s;    // const: pre-canonicalized bytes
  std::vector<std::string> comps;  // slot: attribute path components
  std::vector<std::pair<std::string, Tmpl>> fields;  // record (names sorted)
                                                     // set: names unused
};

struct DynTest {
  uint8_t kind;  // 0 contains, 1 eq, 2 cmp, 3 containsAny, 4 containsAll
  uint8_t op;    // eq: 0 ==, 1 !=; cmp: 0 <, 1 <=, 2 >, 3 >=
  int32_t lit, ok_lit, err_lit;  // -1 when absent
  Tmpl tmpl;                // kinds 0-2
  std::vector<Tmpl> tmpls;  // kinds 3-4 (eagerly-evaluated element set)
};

struct TypeErrTest {
  int32_t lit;   // TYPE_ERR literal id
  uint8_t want;  // required value_key tag byte ('s', 'l', 'S', 'e', ...)
};

struct ScalarSlot {
  uint8_t var;       // 0 principal, 1 action, 2 resource, 3 context/other
  bool deep;         // multi-component path => value always missing (authz;
                     // the admission walk navigates `comps` instead)
  std::string attr;  // attribute path, components joined with \x1f
  std::vector<std::string> comps;  // split path (admission navigation)
  int32_t sidx;
  int32_t present_row;
  SvMap<int32_t> vocab;  // canon(value) -> row
  std::vector<LikeTest> likes;
  std::vector<CmpTest> cmps;
  SvMap<std::vector<int32_t>> set_has;
  std::vector<DynTest> dyns;
  // type-error indicators: active when the slot is PRESENT with a value
  // whose tag differs from `want` (in-vocab values ride the activation
  // rows; this list serves the vocab-miss branch, mirroring the Python
  // lane's value_tag extras)
  std::vector<TypeErrTest> type_errs;
};

struct Table {
  int32_t n_slots = 0;
  int32_t type_slot[3] = {-1, -1, -1};
  int32_t uid_slot[3] = {-1, -1, -1};
  std::vector<int32_t> anc_slots[3];
  SvMap<int32_t> type_map;  // v \x1f type
  SvMap<int32_t> uid_map;   // v \x1f type \x1f id
  SvMap<std::pair<int32_t, std::vector<int32_t>>> anc_map;
  std::vector<ScalarSlot> slots;
};

class BlobReader {
 public:
  BlobReader(const uint8_t *p, size_t n) : p_(p), end_(p + n) {}
  bool ok() const { return ok_; }

  uint8_t u8() { return ok_ && p_ < end_ ? *p_++ : (ok_ = false, 0); }
  int32_t i32() {
    if (!ok_ || end_ - p_ < 4) return ok_ = false, 0;
    int32_t v;
    memcpy(&v, p_, 4);
    p_ += 4;
    return v;
  }
  int64_t i64() {
    if (!ok_ || end_ - p_ < 8) return ok_ = false, 0;
    int64_t v;
    memcpy(&v, p_, 8);
    p_ += 8;
    return v;
  }
  std::string str() {
    int32_t n = i32();
    if (!ok_ || n < 0 || end_ - p_ < n) return ok_ = false, std::string();
    std::string s((const char *)p_, size_t(n));
    p_ += n;
    return s;
  }

 private:
  const uint8_t *p_, *end_;
  bool ok_ = true;
};

bool read_tmpl(BlobReader &r, Tmpl &t, int depth = 0) {
  if (depth > 8) return false;
  t.kind = r.u8();
  if (t.kind == 0) {
    t.s = r.str();
    return r.ok();
  }
  if (t.kind == 4) {
    t.var = r.u8();
    if (t.var > 3) return false;
    int32_t n = r.i32();
    if (!r.ok() || n < 1 || n > 32) return false;
    for (int32_t i = 0; i < n; ++i) t.comps.push_back(r.str());
    return r.ok();
  }
  if (t.kind != 2 && t.kind != 3) return false;
  int32_t n = r.i32();
  if (!r.ok() || n < 0 || n > 1024) return false;
  for (int32_t i = 0; i < n; ++i) {
    t.fields.emplace_back(t.kind == 2 ? r.str() : std::string(), Tmpl{});
    if (!read_tmpl(r, t.fields.back().second, depth + 1)) return false;
  }
  return r.ok();
}

Table *load_table(const uint8_t *blob, size_t len) {
  BlobReader r(blob, len);
  if (r.i32() != 0x43544234) return nullptr;  // "CTB4"
  auto t = std::make_unique<Table>();
  t->n_slots = r.i32();
  for (int v = 0; v < 3; ++v) {
    t->type_slot[v] = r.i32();
    t->uid_slot[v] = r.i32();
    int32_t n = r.i32();
    for (int32_t i = 0; i < n; ++i) t->anc_slots[v].push_back(r.i32());
  }
  int32_t n = r.i32();
  for (int32_t i = 0; i < n; ++i) {
    std::string k = r.str();
    t->type_map[std::move(k)] = r.i32();
  }
  n = r.i32();
  for (int32_t i = 0; i < n; ++i) {
    std::string k = r.str();
    t->uid_map[std::move(k)] = r.i32();
  }
  n = r.i32();
  for (int32_t i = 0; i < n; ++i) {
    std::string k = r.str();
    int32_t row = r.i32();
    int32_t nl = r.i32();
    std::vector<int32_t> lits(size_t(nl >= 0 ? nl : 0));
    for (auto &l : lits) l = r.i32();
    t->anc_map[std::move(k)] = {row, std::move(lits)};
  }
  n = r.i32();
  for (int32_t i = 0; i < n; ++i) {
    ScalarSlot s;
    s.var = r.u8();
    s.deep = r.u8() != 0;
    s.attr = r.str();
    {
      size_t start = 0;
      for (;;) {
        size_t sep = s.attr.find('\x1f', start);
        s.comps.push_back(s.attr.substr(
            start, sep == std::string::npos ? sep : sep - start));
        if (sep == std::string::npos) break;
        start = sep + 1;
      }
    }
    s.sidx = r.i32();
    s.present_row = r.i32();
    int32_t nv = r.i32();
    for (int32_t j = 0; j < nv; ++j) {
      std::string k = r.str();
      s.vocab[std::move(k)] = r.i32();
    }
    int32_t nl = r.i32();
    for (int32_t j = 0; j < nl; ++j) {
      LikeTest lt;
      lt.lit = r.i32();
      int32_t nc = r.i32();
      for (int32_t c = 0; c < nc; ++c) {
        LikeComp comp;
        comp.wild = r.u8() != 0;
        if (!comp.wild) comp.s = r.str();
        lt.comps.push_back(std::move(comp));
      }
      s.likes.push_back(std::move(lt));
    }
    int32_t ncmp = r.i32();
    for (int32_t j = 0; j < ncmp; ++j) {
      CmpTest c;
      c.lit = r.i32();
      c.op = r.u8();
      c.c = r.i64();
      s.cmps.push_back(c);
    }
    int32_t nsh = r.i32();
    for (int32_t j = 0; j < nsh; ++j) {
      std::string k = r.str();
      int32_t cnt = r.i32();
      std::vector<int32_t> lits(size_t(cnt >= 0 ? cnt : 0));
      for (auto &l : lits) l = r.i32();
      s.set_has[std::move(k)] = std::move(lits);
    }
    int32_t nd = r.i32();
    for (int32_t j = 0; j < nd; ++j) {
      DynTest d;
      d.kind = r.u8();
      if (d.kind > 4) return nullptr;
      d.op = r.u8();
      if (d.op > 3 || (d.kind != 2 && d.op > 1)) return nullptr;
      d.lit = r.i32();
      d.ok_lit = r.i32();
      d.err_lit = r.i32();
      if (d.kind >= 3) {
        int32_t nt = r.i32();
        if (!r.ok() || nt < 1 || nt > 256) return nullptr;
        for (int32_t k = 0; k < nt; ++k) {
          d.tmpls.emplace_back();
          if (!read_tmpl(r, d.tmpls.back())) return nullptr;
        }
      } else if (!read_tmpl(r, d.tmpl)) {
        return nullptr;
      }
      s.dyns.push_back(std::move(d));
    }
    int32_t nte = r.i32();
    for (int32_t j = 0; j < nte; ++j) {
      TypeErrTest te;
      te.lit = r.i32();
      te.want = r.u8();
      s.type_errs.push_back(te);
    }
    t->slots.push_back(std::move(s));
  }
  if (!r.ok()) return nullptr;
  return t.release();
}

// ------------------------------------------------------- like-glob matcher

// Mirrors cedar_tpu_torch/lang/ast.py _match_components: DP over (component,
// position); components are literal chunks and wildcards.
bool like_match(const std::vector<LikeComp> &comps, sv s) {
  size_t n = s.size();
  thread_local std::vector<uint8_t> cur, next;
  cur.assign(n + 1, 0);
  next.assign(n + 1, 0);
  cur[0] = 1;
  for (const auto &comp : comps) {
    std::fill(next.begin(), next.end(), 0);
    if (comp.wild) {
      // wildcard: any reachable position reaches all later positions
      uint8_t reach = 0;
      for (size_t i = 0; i <= n; ++i) {
        reach |= cur[i];
        next[i] = reach;
      }
    } else {
      size_t m = comp.s.size();
      for (size_t i = 0; i + m <= n; ++i)
        if (cur[i] && memcmp(s.data() + i, comp.s.data(), m) == 0)
          next[i + m] = 1;
    }
    std::swap(cur, next);
  }
  return cur[n] != 0;
}

// --------------------------------------------------- canonical value keys

// Must stay byte-identical with _canon() in cedar_tpu_torch/native/__init__.py.
// Strings are length-prefixed ("s<len>:<bytes>"): request-controlled bytes
// may contain the \x1f/\x1d structure separators, and without the prefix a
// crafted value could alias a different composite value's canon.
void canon_len_prefix(std::string &out, size_t n) {
  char buf[24];
  int w = snprintf(buf, sizeof buf, "%zu:", n);
  out.append(buf, size_t(w));
}

void canon_str_into(std::string &out, sv s) {
  out.push_back('s');
  canon_len_prefix(out, s.size());
  out.append(s.data(), s.size());
}

void canon_set_into(std::string &out, std::vector<std::string> &elems) {
  // sets canonicalize as a FROZENSET of element keys (lang/values.py
  // set_key): sort AND dedupe, or a duplicated element would change the key
  std::sort(elems.begin(), elems.end());
  elems.erase(std::unique(elems.begin(), elems.end()), elems.end());
  out += "S{";
  for (size_t i = 0; i < elems.size(); ++i) {
    if (i) out.push_back('\x1f');
    out += elems[i];
  }
  out.push_back('}');
}

// record with keys pre-sorted by the caller
std::string canon_record(
    std::initializer_list<std::pair<const char *, const std::string *>> fields) {
  std::string out = "R{";
  bool first = true;
  for (const auto &f : fields) {
    if (!first) out.push_back('\x1f');
    first = false;
    canon_len_prefix(out, strlen(f.first));
    out += f.first;
    out.push_back('\x1d');
    out += *f.second;
  }
  out.push_back('}');
  return out;
}

// -------------------------------------------------------- request features

// A slot value: authz-domain values are strings or sets-of-records.
struct Value {
  enum Kind { MISSING, STRV, SETV } kind = MISSING;
  sv str;
  std::vector<std::string> *elems = nullptr;  // element canon strings
};

struct Features {
  // principal
  sv p_type, p_id;
  std::vector<std::pair<sv, sv>> p_attrs;  // name / namespace
  std::vector<sv> groups;
  std::vector<std::string> extra_elem_canons;
  bool has_extra = false;
  // action
  sv verb;
  // resource entity
  sv r_type, r_id;
  std::vector<std::pair<sv, sv>> r_attrs;
  std::vector<std::string> label_elem_canons, field_elem_canons;
  bool has_label = false, has_field = false;
  // owned storage for composed strings (SA ids, resource paths, lowered keys)
  std::string own0, own1;

  void reset() {
    p_attrs.clear();
    groups.clear();
    extra_elem_canons.clear();
    has_extra = false;
    r_attrs.clear();
    label_elem_canons.clear();
    field_elem_canons.clear();
    has_label = has_field = false;
    own0.clear();
    own1.clear();
    p_type = p_id = verb = r_type = r_id = sv();
  }
};

constexpr sv kUser = "k8s::User";
constexpr sv kGroup = "k8s::Group";
constexpr sv kSA = "k8s::ServiceAccount";
constexpr sv kNode = "k8s::Node";
constexpr sv kPrincipalUID = "k8s::PrincipalUID";
constexpr sv kExtra = "k8s::Extra";
constexpr sv kResource = "k8s::Resource";
constexpr sv kNonResource = "k8s::NonResourceURL";
constexpr sv kAction = "k8s::Action";

int count_colons(sv s) {
  int n = 0;
  for (char c : s)
    if (c == ':') ++n;
  return n;
}

bool starts_with(sv s, sv prefix) {
  return s.size() >= prefix.size() && s.compare(0, prefix.size(), prefix) == 0;
}

sv str_field(const JVal *o, sv k) {
  const JVal *v = o ? o->get(k) : nullptr;
  return v && v->kind == JVal::STR ? v->str : sv();
}

// flags returned per request; mirrored in cedar_tpu_torch/native/__init__.py
enum : uint8_t {
  F_OK = 0,
  F_PARSE_ERROR = 1,
  F_SELF_ALLOW_POLICIES = 2,
  F_SELF_ALLOW_RBAC = 3,
  F_SYSTEM_SKIP = 4,
  F_EXTRAS_OVERFLOW = 5,
  F_ADM_NS_SKIP = 6,  // admission: skipped namespace -> allow
  F_ADM_ERROR = 7,    // admission: shape/conversion issue -> python path
};

constexpr sv kAuthorizerIdentity = "system:authorizer:cedar-authorizer";

bool is_read_only(sv verb) {
  return verb == "get" || verb == "list" || verb == "watch";
}

void dedupe_children(const JVal *obj, std::vector<const JVal *> &out);

// Build all request features from the parsed SAR. Returns a gate flag or
// F_OK. Mirrors get_authorizer_attributes + record_to_cedar_resource.
// python-truthiness helpers for the SAR extraction. The Python lane skips
// FALSY optional blocks ("if ra:"), crashes on truthy wrong-typed ones
// (answering evaluation-error through its broad catch), and only ever
// proceeds with objects/strings of the expected type. Rows this lane
// flags re-run through the Python fallback, whose answer IS the oracle —
// over-flagging is parity-safe, silent coercion is not (the round-5
// type-flip fuzz found this lane evaluating wire shapes the Python lane
// refuses).
bool node_falsy(const JVal *v) {
  switch (v->kind) {
    case JVal::NUL: return true;
    case JVal::BOOL: return !v->b;
    case JVal::STR: return v->str.empty();
    case JVal::ARR:
    case JVal::OBJ: return v->child == nullptr;
    case JVal::NUM: return false;  // "0" is falsy in python; flagging the
      // rare numeric node routes to the fallback instead of raw-text
      // zero detection
  }
  return false;
}

// "if block:" gate: OBJ with children passes; falsy skips (nullptr);
// anything else marks bad (python would crash on attribute access)
const JVal *truthy_obj(const JVal *v, bool &bad) {
  if (!v) return nullptr;
  if (v->kind == JVal::OBJ && v->child) return v;
  if (node_falsy(v)) return nullptr;
  bad = true;
  return nullptr;
}

// field absent or a string; present-but-not-a-string routes the row to
// the Python fallback (shared by the SAR and admission lanes)
bool str_if_present(const JVal *o, sv k) {
  const JVal *v = o ? o->get(k) : nullptr;
  return !v || v->kind == JVal::STR;
}

// fused validate+extract: ONE child walk per field (the split
// sar_str_ok-then-str_field pattern cost a measured ~30% of encode).
// Absent -> empty; wrong-typed -> empty and bad set (python crashes)
sv str_field_vt(const JVal *o, sv k, bool &bad) {
  const JVal *v = o ? o->get(k) : nullptr;
  if (!v) return sv();
  if (v->kind != JVal::STR) {
    bad = true;
    return sv();
  }
  return v->str;
}

// selector SHAPE validation, shared by every resourceAttributes row:
// python parses label/field selectors inside "if ra:" BEFORE any verb
// branching, so even rows whose entity build ignores selectors (e.g.
// impersonation) crash python on flipped selector shapes — those rows
// must flag to the fallback here too
bool sar_selectors_ok(const JVal *ra) {
  for (sv sel_key : {sv("labelSelector"), sv("fieldSelector")}) {
    bool bad = false;
    const JVal *sel = truthy_obj(ra->get(sel_key), bad);
    if (bad) return false;
    const JVal *reqs = sel ? sel->get("requirements") : nullptr;
    if (!reqs) continue;
    if (reqs->kind != JVal::ARR) {
      if (!node_falsy(reqs)) return false;
      continue;
    }
    for (const JVal *rq = reqs->child; rq; rq = rq->next) {
      if (rq->kind != JVal::OBJ) return false;  // req.get crashes
      if (!str_if_present(rq, "operator") || !str_if_present(rq, "key"))
        return false;
      const JVal *vv = rq->get("values");
      if (!vv) continue;
      if (vv->kind != JVal::ARR) {
        if (!node_falsy(vv)) return false;
        continue;
      }
      for (const JVal *v = vv->child; v; v = v->next)
        if (v->kind != JVal::STR) return false;
    }
  }
  return true;
}

uint8_t build_features(const JVal *root, Features &f) {
  bool bad = false;
  const JVal *spec = truthy_obj(root->get("spec"), bad);
  if (bad) return F_PARSE_ERROR;  // truthy non-object: python crashes

  sv user_name = str_field_vt(spec, "user", bad);
  sv user_uid = str_field_vt(spec, "uid", bad);
  if (bad) return F_PARSE_ERROR;

  const JVal *ra =
      truthy_obj(spec ? spec->get("resourceAttributes") : nullptr, bad);
  const JVal *nra =
      truthy_obj(spec ? spec->get("nonResourceAttributes") : nullptr, bad);
  if (bad) return F_PARSE_ERROR;

  sv verb, ns, group, version, resource, subresource, name, path;
  bool resource_request = false;
  if (ra) {
    verb = str_field_vt(ra, "verb", bad);
    ns = str_field_vt(ra, "namespace", bad);
    group = str_field_vt(ra, "group", bad);
    version = str_field_vt(ra, "version", bad);
    resource = str_field_vt(ra, "resource", bad);
    subresource = str_field_vt(ra, "subresource", bad);
    name = str_field_vt(ra, "name", bad);
    if (bad || !sar_selectors_ok(ra)) return F_PARSE_ERROR;
    resource_request = true;
  }
  if (nra) {  // nonResourceAttributes wins last, like the Python builder
    path = str_field_vt(nra, "path", bad);
    verb = str_field_vt(nra, "verb", bad);
    if (bad) return F_PARSE_ERROR;
    resource_request = false;
  }

  // ------- authorizer gates (authorizer.go:38-57)
  if (user_name == kAuthorizerIdentity && is_read_only(verb)) {
    if (group == "cedar.k8s.aws" && resource == "policies")
      return F_SELF_ALLOW_POLICIES;
    if (group == "rbac.authorization.k8s.io") return F_SELF_ALLOW_RBAC;
  }
  if (starts_with(user_name, "system:") &&
      !starts_with(user_name, "system:serviceaccount:") &&
      !starts_with(user_name, "system:node:"))
    return F_SYSTEM_SKIP;

  // ------- principal (user.go:35)
  f.p_type = kUser;
  sv p_name = user_name;
  if (starts_with(user_name, "system:node:") && count_colons(user_name) == 2) {
    f.p_type = kNode;
    p_name = user_name.substr(strlen("system:node:"));
  }
  if (starts_with(user_name, "system:serviceaccount:") &&
      count_colons(user_name) == 3) {
    f.p_type = kSA;
    size_t a = strlen("system:serviceaccount:");
    size_t b = user_name.find(':', a);
    f.p_attrs.emplace_back("namespace", user_name.substr(a, b - a));
    p_name = user_name.substr(b + 1);
  }
  f.p_attrs.emplace_back("name", p_name);
  f.p_id = user_uid.empty() ? user_name : user_uid;

  const JVal *groups = spec ? spec->get("groups") : nullptr;
  if (groups) {
    if (groups->kind == JVal::ARR) {
      // python keeps every element; a non-string member crashes it
      // downstream — flag instead of silently dropping
      for (const JVal *g = groups->child; g; g = g->next) {
        if (g->kind != JVal::STR) return F_PARSE_ERROR;
        f.groups.push_back(g->str);
      }
    } else if (!node_falsy(groups)) {
      // python: tuple() of a non-iterable crashes; of a string tolerates
      // (character groups) — both classes answer via the fallback
      return F_PARSE_ERROR;
    }
  }

  const JVal *extra = spec ? spec->get("extra") : nullptr;
  if (extra && extra->kind != JVal::OBJ && !node_falsy(extra))
    return F_PARSE_ERROR;  // python: (extra).items() crashes
  if (extra && extra->kind == JVal::OBJ && extra->child) {
    f.has_extra = true;
    // json.loads dedupes raw keys (dict: first position, last value), then
    // convertExtra's {k.lower(): v} comprehension dedupes again on the
    // lower-cased key with the same dict semantics (server/http.py:74)
    std::vector<const JVal *> kids;
    dedupe_children(extra, kids);
    std::vector<std::pair<std::string, const JVal *>> lkids;
    for (const JVal *kv : kids) {
      // convertExtra lower-cases keys (server.go:205); canon applied after
      // the dedupe below
      std::string key;
      key.reserve(kv->key.size());
      for (char c : kv->key)
        key.push_back(c >= 'A' && c <= 'Z' ? char(c + 32) : c);
      bool replaced = false;
      for (auto &e : lkids)
        if (e.first == key) {
          e.second = kv;
          replaced = true;
          break;
        }
      if (!replaced) lkids.emplace_back(std::move(key), kv);
    }
    for (auto &e : lkids) {
      const JVal *kv = e.second;
      std::vector<std::string> vals;
      if (kv->kind == JVal::ARR) {
        for (const JVal *v = kv->child; v; v = v->next) {
          // python: tuple(v) keeps every element; non-strings crash the
          // canon downstream — flag instead of silently dropping
          if (v->kind != JVal::STR) return F_PARSE_ERROR;
          std::string c;
          canon_str_into(c, v->str);
          vals.push_back(std::move(c));
        }
      } else {
        // python: tuple() of a non-list crashes or chars-splits a string
        return F_PARSE_ERROR;
      }
      std::string kc, vset;
      canon_str_into(kc, e.first);
      canon_set_into(vset, vals);
      f.extra_elem_canons.push_back(
          canon_record({{"key", &kc}, {"values", &vset}}));
    }
  }

  f.verb = verb;

  // ------- resource entity (entitiy_builders.go)
  if (resource_request && verb == "impersonate") {
    if (resource == "serviceaccounts") {
      f.r_type = kSA;
      f.own0.assign("system:serviceaccount:");
      f.own0.append(ns.data(), ns.size());
      f.own0.push_back(':');
      f.own0.append(name.data(), name.size());
      f.r_id = f.own0;
      f.r_attrs.emplace_back("name", name);
      f.r_attrs.emplace_back("namespace", ns);
    } else if (resource == "uids") {
      f.r_type = kPrincipalUID;
      f.r_id = name;
    } else if (resource == "users") {
      f.r_type = kUser;
      sv rname = name;
      if (starts_with(name, "system:node:") && count_colons(name) == 2) {
        f.r_type = kNode;
        rname = name.substr(strlen("system:node:"));
      }
      f.r_attrs.emplace_back("name", rname);
      f.r_id = name;
    } else if (resource == "groups") {
      f.r_type = kGroup;
      f.r_id = name;
      f.r_attrs.emplace_back("name", name);
    } else if (resource == "userextras") {
      f.r_type = kExtra;
      f.r_id = subresource;
      f.r_attrs.emplace_back("key", subresource);
      if (!name.empty()) f.r_attrs.emplace_back("value", name);
    } else {
      f.r_type = sv();
      f.r_id = sv();
    }
  } else if (resource_request) {
    f.r_type = kResource;
    std::string &p = f.own0;
    if (group.empty()) {
      p.assign("/api/");
    } else {
      p.assign("/apis/");
      p.append(group.data(), group.size());
      p.push_back('/');
    }
    p.append(version.data(), version.size());
    if (!ns.empty()) {
      p.append("/namespaces/");
      p.append(ns.data(), ns.size());
    }
    p.push_back('/');
    p.append(resource.data(), resource.size());
    if (!name.empty()) {
      p.push_back('/');
      p.append(name.data(), name.size());
    }
    if (!subresource.empty()) {
      p.push_back('/');
      p.append(subresource.data(), subresource.size());
    }
    f.r_id = p;
    f.r_attrs.emplace_back("apiGroup", group);
    f.r_attrs.emplace_back("resource", resource);
    if (!name.empty()) f.r_attrs.emplace_back("name", name);
    if (!subresource.empty()) f.r_attrs.emplace_back("subresource", subresource);
    if (!ns.empty()) f.r_attrs.emplace_back("namespace", ns);

    // selectors (server.go:221-309); shapes are already gated by
    // sar_selectors_ok above — tolerant reads here cannot be reached
    // with python-crashing values
    const JVal *ls = ra->get("labelSelector");
    const JVal *reqs =
        ls && ls->kind == JVal::OBJ ? ls->get("requirements") : nullptr;
    if (reqs && reqs->kind == JVal::ARR && reqs->child) {
      for (const JVal *rq = reqs->child; rq; rq = rq->next) {
        if (rq->kind != JVal::OBJ) continue;
        sv op = str_field(rq, "operator");
        const char *mapped = nullptr;
        if (op == "In") mapped = "in";
        else if (op == "NotIn") mapped = "notin";
        else if (op == "Exists") mapped = "exists";
        else if (op == "DoesNotExist") mapped = "!";
        if (!mapped) continue;  // invalid operators dropped
        std::vector<std::string> vals;
        const JVal *vv = rq->get("values");
        if (vv && vv->kind == JVal::ARR)
          for (const JVal *v = vv->child; v; v = v->next)
            if (v->kind == JVal::STR) {
              std::string c;
              canon_str_into(c, v->str);
              vals.push_back(std::move(c));
            }
        std::string key, ops, vset;
        canon_str_into(key, str_field(rq, "key"));
        canon_str_into(ops, mapped);
        canon_set_into(vset, vals);
        f.label_elem_canons.push_back(canon_record(
            {{"key", &key}, {"operator", &ops}, {"values", &vset}}));
      }
      f.has_label = !f.label_elem_canons.empty();
    }
    const JVal *fs = ra->get("fieldSelector");
    const JVal *freqs =
        fs && fs->kind == JVal::OBJ ? fs->get("requirements") : nullptr;
    if (freqs && freqs->kind == JVal::ARR && freqs->child) {
      for (const JVal *rq = freqs->child; rq; rq = rq->next) {
        if (rq->kind != JVal::OBJ) continue;
        sv op = str_field(rq, "operator");
        const JVal *vv = rq->get("values");
        size_t nvals = 0;
        const JVal *first_val = nullptr;
        if (vv && vv->kind == JVal::ARR)
          for (const JVal *v = vv->child; v; v = v->next) {
            if (!first_val) first_val = v;
            ++nvals;
          }
        const char *mapped = nullptr;
        if (op == "In" && nvals == 1) mapped = "=";
        else if (op == "NotIn" && nvals == 1) mapped = "!=";
        if (!mapped) continue;
        sv val = first_val && first_val->kind == JVal::STR ? first_val->str : sv();
        std::string fld, ops, vc;
        canon_str_into(fld, str_field(rq, "key"));
        canon_str_into(ops, mapped);
        canon_str_into(vc, val);
        f.field_elem_canons.push_back(canon_record(
            {{"field", &fld}, {"operator", &ops}, {"value", &vc}}));
      }
      f.has_field = !f.field_elem_canons.empty();
    }
  } else {
    f.r_type = kNonResource;
    f.r_id = path;
    f.r_attrs.emplace_back("path", path);
  }
  return F_OK;
}

// ------------------------------------------------------------ slot lookup

struct ExtrasOut {
  int32_t *buf;
  int32_t cap;
  int32_t n = 0;
  bool overflow = false;
  void push(int32_t v) {
    if (n < cap) buf[n++] = v;
    else overflow = true;
  }
};

// Resolve a dyn template into the probe's canonical value key.
// `slot_canon` is `bool(uint8_t var, const vector<string> &comps,
// string &out)` appending ANY request slot's canonical value (false when
// the chain doesn't resolve — a Cedar attribute-access error). Returns
// false on any error — the caller activates the test's err_lit, mirroring
// the interpreter raising from the same expression.
template <class S>
bool tmpl_canon(const Tmpl &t, S &&slot_canon, std::string &out) {
  if (t.kind == 0) {  // pre-canonicalized constant
    out += t.s;
    return true;
  }
  if (t.kind == 4)  // another request slot's value
    return slot_canon(t.var, t.comps, out);
  if (t.kind == 3) {  // set: canonicalize children, sort + dedupe
    std::vector<std::string> es;
    es.reserve(t.fields.size());
    for (const auto &f : t.fields) {
      std::string ec;
      if (!tmpl_canon(f.second, slot_canon, ec)) return false;
      es.push_back(std::move(ec));
    }
    canon_set_into(out, es);
    return true;
  }
  // record: field names pre-sorted at serialize time (canon_cval parity)
  out += "R{";
  for (size_t i = 0; i < t.fields.size(); ++i) {
    if (i) out.push_back('\x1f');
    canon_len_prefix(out, t.fields[i].first.size());
    out += t.fields[i].first;
    out.push_back('\x1d');
    if (!tmpl_canon(t.fields[i].second, slot_canon, out)) return false;
  }
  out.push_back('}');
  return true;
}

// Parse a canonical Long ("l<decimal>") back to its value; false for any
// other canon tag (the operand is not a Cedar Long).
bool canon_long(const std::string &c, long long *out) {
  if (c.size() < 2 || c[0] != 'l') return false;
  const char *b = c.data() + 1, *e = c.data() + c.size();
  auto res = std::from_chars(b, e, *out);
  return res.ec == std::errc() && res.ptr == e;
}

// Evaluate a slot's dyn tests.
//   contains (kind 0): needs the slot's element canons (`elems`; nullptr =>
//     the slot path is missing / not a set: the test errors, exactly where
//     the interpreter raises evaluating the same expression).
//   eq/neq (kind 1): needs the slot value's full canonical key
//     (`self_canon`; nullptr => missing attribute: access error). Equal
//     Cedar values have equal canons (the canon keys the vocab), and
//     cross-type ==/!= is False/True never an error, so a byte compare IS
//     Cedar equality.
//   cmp (kind 2): both canons must be Longs ("l<decimal>"); anything else
//     is the interpreter's type error.
//   containsAny/All (kinds 3/4): like contains, but over an EAGERLY
//     resolved element-template set — any resolution failure errors the
//     whole test before membership is judged, matching Cedar's eager
//     argument evaluation.
template <class S>
void eval_dyns(const ScalarSlot &s, const std::vector<std::string> *elems,
               const std::string *self_canon, S &&slot_canon,
               ExtrasOut &extras, std::string &scratch) {
  for (const auto &d : s.dyns) {
    if (d.kind == 1) {  // eq / neq: canon byte compare
      if (!self_canon) {
        if (d.err_lit >= 0) extras.push(d.err_lit);
        continue;
      }
      scratch.clear();
      if (!tmpl_canon(d.tmpl, slot_canon, scratch)) {
        if (d.err_lit >= 0) extras.push(d.err_lit);
        continue;
      }
      if (d.ok_lit >= 0) extras.push(d.ok_lit);
      bool hit = *self_canon == scratch;
      if (d.op) hit = !hit;  // != (cross-type != is True)
      if (hit && d.lit >= 0) extras.push(d.lit);
      continue;
    }
    if (d.kind == 2) {  // ordered cmp: both sides must be Longs
      if (!self_canon) {
        if (d.err_lit >= 0) extras.push(d.err_lit);
        continue;
      }
      scratch.clear();
      long long a, b;
      if (!tmpl_canon(d.tmpl, slot_canon, scratch) ||
          !canon_long(*self_canon, &a) || !canon_long(scratch, &b)) {
        // missing attr OR a non-Long operand: Cedar's < <= > >= are
        // defined on Longs only — the interpreter raises a type error
        if (d.err_lit >= 0) extras.push(d.err_lit);
        continue;
      }
      if (d.ok_lit >= 0) extras.push(d.ok_lit);
      bool hit = d.op == 0   ? a < b
                 : d.op == 1 ? a <= b
                 : d.op == 2 ? a > b
                             : a >= b;
      if (hit && d.lit >= 0) extras.push(d.lit);
      continue;
    }
    if (!elems) {
      if (d.err_lit >= 0) extras.push(d.err_lit);
      continue;
    }
    if (d.kind >= 3) {  // containsAny (3) / containsAll (4): Cedar
      // evaluates the argument set EAGERLY — every template must resolve
      // (a later failure errors the whole test, so no early exit on a
      // decided any/all), but membership is pure, so each probe is
      // tested from the shared scratch as it resolves: no allocation
      bool failed = false, any = false, all = true;
      for (const auto &t : d.tmpls) {
        scratch.clear();
        if (!tmpl_canon(t, slot_canon, scratch)) {
          failed = true;
          break;
        }
        bool member = false;
        for (const auto &ec : *elems)
          if (ec == scratch) {
            member = true;
            break;
          }
        any = any || member;
        all = all && member;
      }
      if (failed) {
        if (d.err_lit >= 0) extras.push(d.err_lit);
        continue;
      }
      if (d.ok_lit >= 0) extras.push(d.ok_lit);
      bool hit = d.kind == 3 ? any : all;
      if (hit && d.lit >= 0) extras.push(d.lit);
      continue;
    }
    scratch.clear();
    if (!tmpl_canon(d.tmpl, slot_canon, scratch)) {
      if (d.err_lit >= 0) extras.push(d.err_lit);
      continue;
    }
    if (d.ok_lit >= 0) extras.push(d.ok_lit);
    bool member = false;
    for (const auto &ec : *elems)
      if (ec == scratch) {
        member = true;
        break;
      }
    if (member && d.lit >= 0) extras.push(d.lit);
  }
}

// Resolve one FLAT attribute of an authz request variable — the single
// resolution rule shared by the vocab path (slot_value) and the template
// slot-leaf path (sar_slot_canon), so the two can never diverge on which
// attributes exist.
Value resolve_sar_attr(Features &f, uint8_t var, bool deep, sv attr) {
  Value v;
  if (deep || var == 3) return v;  // context is empty for authz; deep
                                   // paths never resolve in this domain
  if (var == 0) {  // principal
    for (const auto &kv : f.p_attrs)
      if (kv.first == attr) {
        v.kind = Value::STRV;
        v.str = kv.second;
        return v;
      }
    if (attr == sv("extra") && f.has_extra) {
      v.kind = Value::SETV;
      v.elems = &f.extra_elem_canons;
    }
    return v;
  }
  if (var == 1) return v;  // action entities carry no attributes
  // resource
  for (const auto &kv : f.r_attrs)
    if (kv.first == attr) {
      v.kind = Value::STRV;
      v.str = kv.second;
      return v;
    }
  if (attr == sv("labelSelector") && f.has_label) {
    v.kind = Value::SETV;
    v.elems = &f.label_elem_canons;
  } else if (attr == sv("fieldSelector") && f.has_field) {
    v.kind = Value::SETV;
    v.elems = &f.field_elem_canons;
  }
  return v;
}

Value slot_value(Features &f, const ScalarSlot &s) {
  return resolve_sar_attr(f, s.var, s.deep, sv(s.attr));
}

// Resolve a template SLOT leaf for the authz domain: (var, single flat
// attribute) -> append the value's canonical key. Shares resolve_sar_attr
// with slot_value; deep chains, context, and action never resolve here —
// the interpreter errors on the same accesses (authz attributes are flat).
bool sar_slot_canon(Features &f, uint8_t var,
                    const std::vector<std::string> &comps, std::string &out) {
  if (comps.size() != 1) return false;
  Value v = resolve_sar_attr(f, var, false, sv(comps[0]));
  if (v.kind == Value::STRV) {
    canon_str_into(out, v.str);
    return true;
  }
  if (v.kind == Value::SETV) {
    canon_set_into(out, *v.elems);
    return true;
  }
  return false;
}

void encode_one(const Table &t, Features &f, int32_t *codes, ExtrasOut &extras,
                std::string &scratch) {
  for (int32_t i = 0; i < t.n_slots; ++i) codes[i] = 0;

  const sv types[3] = {f.p_type, kAction, f.r_type};
  const sv ids[3] = {f.p_id, f.verb, f.r_id};

  const char vtag[3] = {'0', '1', '2'};
  for (int v = 0; v < 3; ++v) {
    if (t.type_slot[v] >= 0) {
      scratch.clear();
      scratch.push_back(vtag[v]);
      scratch.push_back('\x1f');
      scratch.append(types[v].data(), types[v].size());
      const int32_t *row = sv_find(t.type_map, scratch);
      codes[t.type_slot[v]] = row ? *row : 0;
    }
    if (t.uid_slot[v] >= 0) {
      scratch.clear();
      scratch.push_back(vtag[v]);
      scratch.push_back('\x1f');
      scratch.append(types[v].data(), types[v].size());
      scratch.push_back('\x1f');
      scratch.append(ids[v].data(), ids[v].size());
      const int32_t *row = sv_find(t.uid_map, scratch);
      codes[t.uid_slot[v]] = row ? *row : 0;
    }
  }

  // principal ancestors: group parent entities (user.go:23-27). Actions and
  // resources have no parents in the authz domain.
  if (!t.anc_slots[0].empty() && !f.groups.empty()) {
    size_t filled = 0;
    const auto &slots = t.anc_slots[0];
    for (sv g : f.groups) {
      scratch.assign("0\x1f");
      scratch.append(kGroup.data(), kGroup.size());
      scratch.push_back('\x1f');
      scratch.append(g.data(), g.size());
      const auto *entry = sv_find(t.anc_map, scratch);
      if (!entry || entry->first == 0) continue;
      if (filled < slots.size()) {
        codes[slots[filled++]] = entry->first;
      } else {
        for (int32_t lid : entry->second) extras.push(lid);
      }
    }
  }

  std::string vcanon;  // the slot value's canon: vocab key + dyn eq operand
  for (const auto &s : t.slots) {
    Value v = slot_value(f, s);
    vcanon.clear();
    const std::string *self = nullptr;
    if (v.kind == Value::STRV) {
      canon_str_into(vcanon, v.str);
      self = &vcanon;
    } else if (v.kind == Value::SETV) {
      canon_set_into(vcanon, *v.elems);  // sorts elems in place (stable key)
      self = &vcanon;
    }
    if (!s.dyns.empty()) {
      auto slot_canon = [&f](uint8_t var, const std::vector<std::string> &c,
                             std::string &out) {
        return sar_slot_canon(f, var, c, out);
      };
      eval_dyns(s, v.kind == Value::SETV ? v.elems : nullptr, self,
                slot_canon, extras, scratch);
    }
    if (v.kind == Value::MISSING) continue;

    const int32_t *row = sv_find(s.vocab, vcanon);
    if (row) {
      codes[s.sidx] = *row;
    } else {
      codes[s.sidx] = s.present_row;
      if (v.kind == Value::STRV) {
        for (const auto &lt : s.likes)
          if (like_match(lt.comps, v.str)) extras.push(lt.lit);
        // cmp tests only apply to longs; authz values are strings
      }
      if (!s.type_errs.empty()) {
        // authz slot values are strings or string sets
        const uint8_t tag = v.kind == Value::STRV ? 's' : 'S';
        for (const auto &te : s.type_errs)
          if (te.want != tag) extras.push(te.lit);
      }
    }
    if (v.kind == Value::SETV && !s.set_has.empty()) {
      for (const auto &ec : *v.elems) {
        const auto *lits = sv_find(s.set_has, ec);
        if (lits)
          for (int32_t lid : *lits) extras.push(lid);
      }
    }
  }
}

// ======================= admission encoding ==============================
// Raw AdmissionReview JSON -> feature codes over the same activation table,
// mirroring cedar_tpu/entities/admission.py + server/admission.py (reference
// internal/server/entities/admission.go:160-369). Rows the native walk
// cannot prove identical to the Python path (unsupported leaf types, parse
// quirks, pathological shapes) are flagged for the exact Python fallback.

struct CVal {
  enum Kind : uint8_t { STRV, LONGV, BOOLV, IPV, SETV, RECV, ENTV } kind = STRV;
  sv str;       // STRV payload / IPV raw text / ENTV id
  sv ent_type;  // ENTV type
  int64_t l = 0;
  bool b = false;
  std::vector<std::pair<sv, CVal *>> fields;  // RECV
  std::vector<CVal *> elems;                  // SETV
  // memoized canonical key: several table slots (and the dyn template
  // resolver) canonicalize the SAME node per request — labels-bearing
  // admission objects paid ~1us/entry re-canonicalizing across slots.
  // Valid iff canon_done; make() clears the flag, the string keeps its
  // capacity across pool reuse.
  std::string canon;
  bool canon_done = false;
};

class CPool {
 public:
  CVal *make(CVal::Kind k) {
    if (used_ == pool_.size()) pool_.emplace_back();
    CVal *v = &pool_[used_++];
    v->kind = k;
    v->str = sv();
    v->ent_type = sv();
    v->l = 0;
    v->b = false;
    v->fields.clear();
    v->elems.clear();
    v->canon_done = false;
    return v;
  }
  void reset() { used_ = 0; }

 private:
  std::deque<CVal> pool_;
  size_t used_ = 0;
};

// g/v/k-conditional map attributes; MUST stay in sync with
// KNOWN_KEY_VALUE_STRING_MAP_ATTRIBUTES / .._SLICE_.. in
// cedar_tpu/entities/admission.py (reference admission.go:195-295).
const SvMap<char> &kv_string_attrs() {
  static const SvMap<char> m = [] {
    SvMap<char> t;
    auto add = [&](const char *g, const char *v, const char *k,
                   std::initializer_list<const char *> attrs) {
      for (const char *a : attrs) {
        std::string key;
        (((key += g) += '\x1f') += v) += '\x1f';
        ((key += k) += '\x1f') += a;
        t[std::move(key)] = 1;
      }
    };
    add("core", "v1", "ConfigMap", {"data", "binaryData"});
    add("core", "v1", "CSIPersistentVolumeSource", {"volumeAttributes"});
    add("core", "v1", "CSIVolumeSource", {"volumeAttributes"});
    add("core", "v1", "FlexPersistentVolumeSource", {"options"});
    add("core", "v1", "FlexVolumeSource", {"options"});
    add("core", "v1", "PersistentVolumeClaimStatus",
        {"allocatedResourceStatuses"});
    add("core", "v1", "Pod", {"nodeSelector"});
    add("core", "v1", "ReplicationController", {"selector"});
    add("core", "v1", "Secret", {"data", "stringData"});
    add("core", "v1", "Service", {"selector"});
    add("discovery", "v1", "Endpoint", {"deprecatedTopology"});
    add("node", "v1", "Scheduling", {"nodeSelectors"});
    add("storage", "v1", "StorageClass", {"parameters"});
    add("storage", "v1", "VolumeAttachmentStatus", {"attachmentMetadata"});
    add("meta", "v1", "LabelSelector", {"matchLabels"});
    add("meta", "v1", "ObjectMeta", {"annotations", "labels"});
    return t;
  }();
  return m;
}

const SvMap<char> &kv_slice_attrs() {
  static const SvMap<char> m = [] {
    SvMap<char> t;
    auto add = [&](const char *g, const char *v, const char *k, const char *a) {
      std::string key;
      (((key += g) += '\x1f') += v) += '\x1f';
      ((key += k) += '\x1f') += a;
      t[std::move(key)] = 1;
    };
    add("authentication", "v1", "UserInfo", "extra");
    add("authorization", "v1", "SubjectAccessReview", "extra");
    add("certificates", "v1", "CertificateSigningRequest", "extra");
    return t;
  }();
  return m;
}

bool is_ip_key(sv k) {
  return k == "podIP" || k == "clusterIP" || k == "loadBalancerIP" ||
         k == "hostIP" || k == "ip" || k == "podIPs" || k == "hostIPs";
}

// python int(str): optional surrounding whitespace, optional sign, digits
// with single underscores BETWEEN digits. Returns false when python would
// raise ValueError.
bool py_int_parse(sv s, long long *out) {
  size_t a = 0, b = s.size();
  auto is_ws = [](char c) {
    return c == ' ' || c == '\t' || c == '\n' || c == '\r' || c == '\f' ||
           c == '\v';
  };
  while (a < b && is_ws(s[a])) ++a;
  while (b > a && is_ws(s[b - 1])) --b;
  if (a == b) return false;
  bool neg = false;
  if (s[a] == '+' || s[a] == '-') {
    neg = s[a] == '-';
    ++a;
  }
  if (a == b) return false;
  long long v = 0;
  bool last_digit = false;
  for (size_t i = a; i < b; ++i) {
    char c = s[i];
    if (c == '_') {
      if (!last_digit || i + 1 == b) return false;
      last_digit = false;
      continue;
    }
    if (c < '0' || c > '9') return false;
    if (v > (1ll << 40)) return false;  // far past any prefix length
    v = v * 10 + (c - '0');
    last_digit = true;
  }
  if (!last_digit) return false;
  *out = neg ? -v : v;
  return true;
}

// 0 = not an ip (python IPAddr.parse raises -> raw string kept),
// 1 = ip, 2 = can't prove parity (scoped IPv6 etc.) -> python fallback
int classify_ip(sv s) {
  sv addr = s;
  size_t slash = s.rfind('/');
  if (slash != sv::npos) {
    addr = s.substr(0, slash);
    sv pfx = s.substr(slash + 1);
    long long p;
    if (!py_int_parse(pfx, &p)) return 0;  // int(p) raises -> raw string
    bool v6 = addr.find(':') != sv::npos;
    if (p < 0 || p > (v6 ? 128 : 32)) return 0;  // bad prefix -> raw string
  }
  if (addr.find('%') != sv::npos) return 2;  // python 3.9+ parses zone ids
  if (addr.find(':') != sv::npos) {
    char buf[16];
    std::string z(addr);
    if (inet_pton(AF_INET6, z.c_str(), buf) != 1) return 0;
    // only admit v6 spellings already in canonical (inet_ntop) form: the
    // IPV canon (canon_cval) byte-compares address text as the equality
    // basis, so "0:0:0:0:0:0:0:1" must not be provable — it would compare
    // unequal to "::1" while python's parsed addresses compare equal
    char txt[INET6_ADDRSTRLEN];
    if (!inet_ntop(AF_INET6, buf, txt, sizeof txt)) return 2;
    return z == txt ? 1 : 2;
  }
  // strict dotted-quad: 4 decimal octets, 0-255, no leading zeros
  int octets = 0;
  size_t i = 0;
  while (i < addr.size()) {
    size_t start = i;
    int v = 0;
    while (i < addr.size() && addr[i] >= '0' && addr[i] <= '9') {
      v = v * 10 + (addr[i] - '0');
      if (v > 255) return 0;
      ++i;
    }
    size_t len = i - start;
    if (len == 0 || len > 3) return 0;
    if (len > 1 && addr[start] == '0') return 0;
    ++octets;
    if (i == addr.size()) break;
    if (addr[i] != '.') return 0;
    ++i;
    if (i == addr.size()) return 0;  // trailing dot
  }
  return octets == 4 ? 1 : 0;
}

struct AdmCtx {
  CPool *cp;
  sv group, kversion, kkind;  // request g/v/k for the known-map tables
  bool error = false;         // -> F_ADM_ERROR (python fallback re-raises)
};

void dedupe_insert(std::vector<std::pair<sv, CVal *>> &fields, sv key,
                   CVal *val) {
  // python dicts deduplicate JSON keys (last value wins)
  for (auto &f : fields)
    if (f.first == key) {
      f.second = val;
      return;
    }
  fields.emplace_back(key, val);
}

// Resolve duplicate JSON keys BEFORE any per-value filtering: python's
// json.loads builds the dict first (last value wins, whatever its type),
// then the walk filters — filtering before dedup would let a skipped later
// duplicate resurrect an earlier value.
void dedupe_children(const JVal *obj,
                     std::vector<const JVal *> &out) {
  out.clear();
  for (const JVal *kv = obj->child; kv; kv = kv->next) {
    bool replaced = false;
    for (auto &existing : out)
      if (existing->key == kv->key) {
        existing = kv;
        replaced = true;
        break;
      }
    if (!replaced) out.push_back(kv);
  }
}

CVal *key_value_set(AdmCtx &c, const JVal *obj) {
  // map[string]string -> Set<{key, value}>; non-string values skip the key
  CVal *s = c.cp->make(CVal::SETV);
  std::vector<const JVal *> kids;
  dedupe_children(obj, kids);
  for (const JVal *kv : kids) {
    if (kv->kind != JVal::STR) continue;
    CVal *r = c.cp->make(CVal::RECV);
    CVal *k = c.cp->make(CVal::STRV);
    k->str = kv->key;
    CVal *v = c.cp->make(CVal::STRV);
    v->str = kv->str;
    r->fields.emplace_back("key", k);
    r->fields.emplace_back("value", v);
    s->elems.push_back(r);
  }
  return s;
}

CVal *key_value_slice_set(AdmCtx &c, const JVal *obj) {
  // map[string][]string -> Set<{key, value: Set<String>}>
  CVal *s = c.cp->make(CVal::SETV);
  std::vector<const JVal *> kids;
  dedupe_children(obj, kids);
  for (const JVal *kv : kids) {
    if (kv->kind != JVal::ARR) continue;
    CVal *vals = c.cp->make(CVal::SETV);
    for (const JVal *e = kv->child; e; e = e->next)
      if (e->kind == JVal::STR) {
        CVal *ev = c.cp->make(CVal::STRV);
        ev->str = e->str;
        vals->elems.push_back(ev);
      }
    CVal *r = c.cp->make(CVal::RECV);
    CVal *k = c.cp->make(CVal::STRV);
    k->str = kv->key;
    r->fields.emplace_back("key", k);
    r->fields.emplace_back("value", vals);
    s->elems.push_back(r);
  }
  return s;
}

CVal *adm_walk(AdmCtx &c, int depth, sv key, const JVal *v) {
  if (depth == 0) {
    c.error = true;  // python raises "max depth reached"
    return nullptr;
  }
  switch (v->kind) {
    case JVal::NUL:
      return nullptr;
    case JVal::OBJ: {
      thread_local std::string k;
      k.assign(c.group.data(), c.group.size());
      k += '\x1f';
      k.append(c.kversion.data(), c.kversion.size());
      k += '\x1f';
      k.append(c.kkind.data(), c.kkind.size());
      k += '\x1f';
      k.append(key.data(), key.size());
      if (sv_find(kv_string_attrs(), k)) return key_value_set(c, v);
      if (sv_find(kv_slice_attrs(), k)) return key_value_slice_set(c, v);
      if (key == "labels" || key == "annotations") return key_value_set(c, v);
      CVal *r = c.cp->make(CVal::RECV);
      std::vector<const JVal *> kids;
      dedupe_children(v, kids);
      for (const JVal *kv : kids) {
        CVal *val = adm_walk(c, depth - 1, kv->key, kv);
        if (c.error) return nullptr;
        if (!val) continue;  // nulls and empty nested records are skipped
        r->fields.emplace_back(kv->key, val);
      }
      if (r->fields.empty()) return nullptr;
      return r;
    }
    case JVal::ARR: {
      CVal *s = c.cp->make(CVal::SETV);
      for (const JVal *it = v->child; it; it = it->next) {
        CVal *e = adm_walk(c, depth - 1, key, it);
        if (c.error) return nullptr;
        if (e) s->elems.push_back(e);
      }
      return s;
    }
    case JVal::STR: {
      if (is_ip_key(key)) {
        int cls = classify_ip(v->str);
        if (cls == 2) {
          c.error = true;
          return nullptr;
        }
        if (cls == 1) {
          CVal *x = c.cp->make(CVal::IPV);
          x->str = v->str;
          return x;
        }
      }
      CVal *x = c.cp->make(CVal::STRV);
      x->str = v->str;
      return x;
    }
    case JVal::BOOL: {
      CVal *x = c.cp->make(CVal::BOOLV);
      x->b = v->b;
      return x;
    }
    case JVal::NUM: {
      sv t = v->str;
      for (char ch : t)
        if (ch == '.' || ch == 'e' || ch == 'E') {
          c.error = true;  // python json gives float -> walk raises
          return nullptr;
        }
      int64_t x = 0;
      auto res = std::from_chars(t.data(), t.data() + t.size(), x);
      if (res.ec != std::errc() || res.ptr != t.data() + t.size()) {
        c.error = true;  // out-of-int64 (python bigint) or malformed
        return nullptr;
      }
      CVal *n = c.cp->make(CVal::LONGV);
      n->l = x;
      return n;
    }
  }
  c.error = true;
  return nullptr;
}

// top-level object -> record: per-field walk with a fresh depth budget
// (entities/admission.py unstructured_to_record); empty top records are
// kept (only NESTED empties drop)
CVal *adm_top_record(AdmCtx &c, const JVal *obj) {
  CVal *r = c.cp->make(CVal::RECV);
  std::vector<const JVal *> kids;
  dedupe_children(obj, kids);
  for (const JVal *kv : kids) {
    if (kv->kind == JVal::NUL) continue;
    CVal *val = adm_walk(c, 32, kv->key, kv);  // MAX_WALK_DEPTH
    if (c.error) return nullptr;
    if (!val) continue;
    r->fields.emplace_back(kv->key, val);
  }
  return r;
}

void canon_cval(const CVal *v, std::string &out);

// one canon construction per node per request: recursive calls route
// through the memoized canon_cval wrapper below, so nested sets/records
// cache too (CVal.canon / canon_done, cleared by CPool::make)
void canon_cval_build(const CVal *v, std::string &out) {
  switch (v->kind) {
    case CVal::STRV:
      canon_str_into(out, v->str);
      return;
    case CVal::LONGV: {
      char buf[24];
      int n = snprintf(buf, sizeof buf, "l%lld", (long long)v->l);
      out.append(buf, size_t(n));
      return;
    }
    case CVal::BOOLV:
      out.push_back(v->b ? 't' : 'f');
      return;
    case CVal::IPV: {
      // value_key tag "i": _canon() refuses it, so no vocab/set_has key
      // can ever hold one. The canon still NORMALIZES (canonical address
      // text — classify_ip only admits strict dotted-quad v4 and
      // ntop-round-trip v6 — plus the PARSED prefix length, defaulted to
      // the address family's max): the dyn eq tests byte-compare these
      // canons, and python IPAddr equality is (addr, prefixlen)
      sv s = v->str;
      sv a = s;
      long long plen = -1;
      size_t slash = s.rfind('/');
      if (slash != sv::npos) {
        a = s.substr(0, slash);
        py_int_parse(s.substr(slash + 1), &plen);  // valid per classify_ip
      }
      if (plen < 0) plen = a.find(':') != sv::npos ? 128 : 32;
      out.push_back('i');
      out.append(a.data(), a.size());
      char buf[8];
      int n = snprintf(buf, sizeof buf, "/%lld", plen);
      out.append(buf, size_t(n));
      return;
    }
    case CVal::ENTV:
      out.push_back('e');
      canon_len_prefix(out, v->ent_type.size());
      out.append(v->ent_type.data(), v->ent_type.size());
      canon_len_prefix(out, v->str.size());
      out.append(v->str.data(), v->str.size());
      return;
    case CVal::SETV: {
      std::vector<std::string> es;
      es.reserve(v->elems.size());
      for (const CVal *e : v->elems) {
        std::string ec;
        canon_cval(e, ec);
        es.push_back(std::move(ec));
      }
      canon_set_into(out, es);
      return;
    }
    case CVal::RECV: {
      std::vector<const std::pair<sv, CVal *> *> fs;
      fs.reserve(v->fields.size());
      for (const auto &f : v->fields) fs.push_back(&f);
      std::sort(fs.begin(), fs.end(),
                [](const auto *a, const auto *b) { return a->first < b->first; });
      out += "R{";
      for (size_t i = 0; i < fs.size(); ++i) {
        if (i) out.push_back('\x1f');
        canon_len_prefix(out, fs[i]->first.size());
        out.append(fs[i]->first.data(), fs[i]->first.size());
        out.push_back('\x1d');
        canon_cval(fs[i]->second, out);
      }
      out.push_back('}');
      return;
    }
  }
}

void canon_cval(const CVal *v, std::string &out) {
  if (!v->canon_done) {
    CVal *m = const_cast<CVal *>(v);  // pooled storage is never truly const
    m->canon.clear();
    canon_cval_build(v, m->canon);
    m->canon_done = true;
  }
  out += v->canon;
}

const CVal *cval_nav(const CVal *root, const std::vector<std::string> &comps) {
  // compiler/encode.py _slot_value: records only; anything else is MISSING
  const CVal *cur = root;
  for (const auto &comp : comps) {
    if (!cur || cur->kind != CVal::RECV) return nullptr;
    const CVal *nxt = nullptr;
    for (const auto &f : cur->fields)
      if (f.first == comp) nxt = f.second;
    cur = nxt;
    if (!cur) return nullptr;
  }
  return cur;
}

constexpr sv kAdmAction = "k8s::admission::Action";
constexpr sv kSkipNs1 = "kube-system";
constexpr sv kSkipNs2 = "cedar-k8s-authz-system";

struct AdmFeatures {
  sv uid, op, action_id;
  sv p_type, p_id;
  std::vector<sv> groups;
  CVal *p_rec = nullptr;
  std::string r_type;  // <group or core>::<kind version>::<Kind>
  std::string r_path;  // kubernetes URL path (the resource entity id)
  CVal *res = nullptr;
  CVal *ctx = nullptr;  // {oldObject: <old attrs>} on UPDATE-style requests

  void reset() {
    groups.clear();
    p_rec = res = ctx = nullptr;
    r_type.clear();
    r_path.clear();
    uid = op = action_id = p_type = p_id = sv();
  }
};

// request.kind / request.resource: python's known-field extraction
// ignores unknown keys and tolerates odd values (entities/admission.py
// from_admission_review), so this strict shape check is DELIBERATELY a
// superset — the rare flagged row answers through the Python fallback,
// which is the oracle; strictness here costs fallback speed, never parity
bool gv_shape_ok(const JVal *o, sv third_key) {
  if (!o || o->kind == JVal::NUL) return true;  // `or {}` -> defaults
  if (o->kind != JVal::OBJ) return false;
  for (const JVal *kv = o->child; kv; kv = kv->next) {
    if (kv->key != "group" && kv->key != "version" && kv->key != third_key)
      return false;
    if (kv->kind != JVal::STR) return false;
  }
  return true;
}

uint8_t build_adm(const JVal *root, AdmFeatures &f, AdmCtx &c, Arena &arena) {
  const JVal *req = root->get("request");
  if (!req || req->kind != JVal::OBJ) return F_ADM_ERROR;
  if (!str_if_present(req, "uid") || !str_if_present(req, "namespace") ||
      !str_if_present(req, "name") || !str_if_present(req, "subResource"))
    return F_ADM_ERROR;
  f.uid = str_field(req, "uid");
  if (f.uid.size() > 255) return F_ADM_ERROR;  // uid passback buffer bound
  // DEFERRED namespace skip: the decision is recorded here but only
  // returned after the FULL review validates — the reference decodes the
  // whole AdmissionReview into typed structs before Handle()'s namespace
  // check runs, so a malformed review in a skipped namespace must answer
  // through the conversion-error path (python allow-on-error), not the
  // skip. (Found by the type-flip fuzz: "userInfo": 7 in kube-system.)
  sv ns = str_field(req, "namespace");
  const bool ns_skip = (ns == kSkipNs1 || ns == kSkipNs2);
  f.op = str_field(req, "operation");
  if (f.op == "CREATE") f.action_id = "create";
  else if (f.op == "UPDATE") f.action_id = "update";
  else if (f.op == "DELETE") f.action_id = "delete";
  else if (f.op == "CONNECT") f.action_id = "connect";
  else return F_ADM_ERROR;  // python raises "unsupported operation"

  // ---- principal (entities/user.py user_to_cedar_entity; admission keeps
  // extra keys as-is — no convertExtra lower-casing on this path)
  const JVal *ui = req->get("userInfo");
  if (ui && ui->kind == JVal::NUL) ui = nullptr;  // `or {}`
  if (ui && ui->kind != JVal::OBJ) return F_ADM_ERROR;
  if (!str_if_present(ui, "username") || !str_if_present(ui, "uid"))
    return F_ADM_ERROR;
  sv uname = str_field(ui, "username");
  sv uuid = str_field(ui, "uid");
  f.p_type = kUser;
  sv p_name = uname;
  sv p_ns;
  if (starts_with(uname, "system:node:") && count_colons(uname) == 2) {
    f.p_type = kNode;
    p_name = uname.substr(strlen("system:node:"));
  }
  if (starts_with(uname, "system:serviceaccount:") && count_colons(uname) == 3) {
    f.p_type = kSA;
    size_t a = strlen("system:serviceaccount:");
    size_t b = uname.find(':', a);
    p_ns = uname.substr(a, b - a);
    p_name = uname.substr(b + 1);
  }
  f.p_id = uuid.empty() ? uname : uuid;
  const JVal *groups = ui ? ui->get("groups") : nullptr;
  if (groups && groups->kind != JVal::NUL) {
    if (groups->kind != JVal::ARR) return F_ADM_ERROR;
    for (const JVal *g = groups->child; g; g = g->next) {
      if (g->kind != JVal::STR) return F_ADM_ERROR;
      f.groups.push_back(g->str);
    }
  }
  f.p_rec = c.cp->make(CVal::RECV);
  {
    CVal *nm = c.cp->make(CVal::STRV);
    nm->str = p_name;
    if (!p_ns.empty()) {
      CVal *nsv = c.cp->make(CVal::STRV);
      nsv->str = p_ns;
      f.p_rec->fields.emplace_back("namespace", nsv);
    }
    f.p_rec->fields.emplace_back("name", nm);
    const JVal *extra = ui ? ui->get("extra") : nullptr;
    if (extra && extra->kind != JVal::NUL) {
      if (extra->kind != JVal::OBJ) return F_ADM_ERROR;
      if (extra->child) {
        CVal *set = c.cp->make(CVal::SETV);
        // duplicate extra keys: python's json.loads keeps only the last
        // value per key (dict), like every other object walk here
        std::vector<const JVal *> extra_kids;
        dedupe_children(extra, extra_kids);
        for (const JVal *kv : extra_kids) {
          if (kv->kind != JVal::ARR) return F_ADM_ERROR;
          CVal *vals = c.cp->make(CVal::SETV);
          for (const JVal *e = kv->child; e; e = e->next) {
            if (e->kind != JVal::STR) return F_ADM_ERROR;
            CVal *ev = c.cp->make(CVal::STRV);
            ev->str = e->str;
            vals->elems.push_back(ev);
          }
          CVal *r = c.cp->make(CVal::RECV);
          CVal *k = c.cp->make(CVal::STRV);
          k->str = kv->key;
          r->fields.emplace_back("key", k);
          r->fields.emplace_back("values", vals);
          set->elems.push_back(r);
        }
        f.p_rec->fields.emplace_back("extra", set);
      }
    }
  }

  // ---- resource entity type + id (entities/admission.py:207-224)
  const JVal *kind = req->get("kind");
  if (!gv_shape_ok(kind, "kind")) return F_ADM_ERROR;
  if (kind && kind->kind != JVal::OBJ) kind = nullptr;
  const JVal *gvr = req->get("resource");
  if (!gv_shape_ok(gvr, "resource")) return F_ADM_ERROR;
  if (gvr && gvr->kind != JVal::OBJ) gvr = nullptr;
  sv kver = str_field(kind, "version"), kkind = str_field(kind, "kind");
  sv rgroup = str_field(gvr, "group"), rver = str_field(gvr, "version");
  sv rres = str_field(gvr, "resource");
  sv name = str_field(req, "name"), subres = str_field(req, "subResource");
  sv egroup = rgroup.empty() ? sv("core") : rgroup;
  f.r_type.assign(egroup.data(), egroup.size());
  f.r_type += "::";
  f.r_type.append(kver.data(), kver.size());
  f.r_type += "::";
  f.r_type.append(kkind.data(), kkind.size());
  c.group = egroup;
  c.kversion = kver;
  c.kkind = kkind;
  std::string &p = f.r_path;
  if (rgroup.empty()) {
    p.assign("/api/");
  } else {
    p.assign("/apis/");
    p.append(rgroup.data(), rgroup.size());
    p.push_back('/');
  }
  p.append(rver.data(), rver.size());
  if (!ns.empty()) {
    p.append("/namespaces/");
    p.append(ns.data(), ns.size());
  }
  p.push_back('/');
  p.append(rres.data(), rres.size());
  if (!name.empty()) {
    p.push_back('/');
    p.append(name.data(), name.size());
  }
  if (!subres.empty()) {
    p.push_back('/');
    p.append(subres.data(), subres.size());
  }

  // ---- object walk (oldObject for DELETE, handler.go:95-99)
  bool obj_bad = false;
  auto load_obj = [&](const char *key) -> const JVal * {
    const JVal *o = req->get(key);
    if (!o || o->kind == JVal::NUL) return nullptr;
    if (o->kind == JVal::STR) {  // JSON-string payload: python json.loads
      JsonParser nested(o->str.data(), o->str.size(), arena);
      const JVal *parsed = nested.parse();
      if (!parsed) obj_bad = true;  // python raises -> allow-on-error
      return parsed;
    }
    return o;
  };
  const JVal *obj = load_obj("object");
  const JVal *oldo = load_obj("oldObject");
  if (obj_bad) return F_ADM_ERROR;
  if (ns_skip) {
    // deferred namespace skip fires HERE: everything above mirrors the
    // decode surface whose failures the Python lane answers with
    // allow-on-error (typed fields, nested JSON-string payloads); the
    // entity build below is handler-stage work the Python handler only
    // runs AFTER its own namespace check, and its failure modes
    // ("unstructured data is nil", unsupported walks) do not apply to
    // skipped rows
    return F_ADM_NS_SKIP;
  }
  const JVal *main_obj = (f.op == "DELETE") ? oldo : obj;
  if (!main_obj || main_obj->kind != JVal::OBJ)
    return F_ADM_ERROR;  // "unstructured data is nil" / non-object payload
  f.res = adm_top_record(c, main_obj);
  if (c.error) return F_ADM_ERROR;
  if (oldo && f.op != "DELETE") {
    if (oldo->kind != JVal::OBJ) return F_ADM_ERROR;
    CVal *old_rec = adm_top_record(c, oldo);
    if (c.error) return F_ADM_ERROR;
    // old entity re-IDed by the review uid; linked from the new object and
    // exposed as context.oldObject (handler.go:107-139)
    CVal *ent = c.cp->make(CVal::ENTV);
    ent->ent_type = sv(f.r_type);
    ent->str = f.uid;
    dedupe_insert(f.res->fields, "oldObject", ent);
    f.ctx = c.cp->make(CVal::RECV);
    if (old_rec) f.ctx->fields.emplace_back("oldObject", old_rec);
  }
  return F_OK;
}

void encode_adm_one(const Table &t, AdmFeatures &f, int32_t *codes,
                    ExtrasOut &extras, std::string &scratch) {
  for (int32_t i = 0; i < t.n_slots; ++i) codes[i] = 0;

  const sv types[3] = {f.p_type, kAdmAction, sv(f.r_type)};
  const sv ids[3] = {f.p_id, f.action_id, sv(f.r_path)};
  const char vtag[3] = {'0', '1', '2'};
  for (int v = 0; v < 3; ++v) {
    if (t.type_slot[v] >= 0) {
      scratch.clear();
      scratch.push_back(vtag[v]);
      scratch.push_back('\x1f');
      scratch.append(types[v].data(), types[v].size());
      const int32_t *row = sv_find(t.type_map, scratch);
      codes[t.type_slot[v]] = row ? *row : 0;
    }
    if (t.uid_slot[v] >= 0) {
      scratch.clear();
      scratch.push_back(vtag[v]);
      scratch.push_back('\x1f');
      scratch.append(types[v].data(), types[v].size());
      scratch.push_back('\x1f');
      scratch.append(ids[v].data(), ids[v].size());
      const int32_t *row = sv_find(t.uid_map, scratch);
      codes[t.uid_slot[v]] = row ? *row : 0;
    }
  }

  // principal ancestors: the group parents
  if (!t.anc_slots[0].empty() && !f.groups.empty()) {
    size_t filled = 0;
    const auto &slots = t.anc_slots[0];
    for (sv g : f.groups) {
      scratch.assign("0\x1f");
      scratch.append(kGroup.data(), kGroup.size());
      scratch.push_back('\x1f');
      scratch.append(g.data(), g.size());
      const auto *entry = sv_find(t.anc_map, scratch);
      if (!entry || entry->first == 0) continue;
      if (filled < slots.size()) {
        codes[slots[filled++]] = entry->first;
      } else {
        for (int32_t lid : entry->second) extras.push(lid);
      }
    }
  }
  // action ancestor: create/update/delete/connect all parent to "all"
  // (entities/admission.py admission_action_entities)
  if (!t.anc_slots[1].empty()) {
    scratch.assign("1\x1f");
    scratch.append(kAdmAction.data(), kAdmAction.size());
    scratch.append("\x1f" "all");
    const auto *entry = sv_find(t.anc_map, scratch);
    if (entry && entry->first != 0) codes[t.anc_slots[1][0]] = entry->first;
  }

  std::string vcanon;  // the slot value's canon: vocab key + dyn eq operand
  std::vector<std::string> ecs;  // SET slots: per-element canons, built ONCE
  for (const auto &s : t.slots) {
    const CVal *root = s.var == 0   ? f.p_rec
                       : s.var == 2 ? f.res
                       : s.var == 3 ? f.ctx
                                    : nullptr;
    const CVal *v = root ? cval_nav(root, s.comps) : nullptr;
    vcanon.clear();
    ecs.clear();
    const bool is_set = v && v->kind == CVal::SETV;
    const bool want_elems = is_set && (!s.dyns.empty() || !s.set_has.empty());
    if (want_elems) {
      // one element-canon pass serves all three consumers: the set's own
      // canon (canon_set_into — identical construction to canon_cval's
      // SETV branch, sorting + deduping ecs in place, which membership
      // probes below don't care about), the dyn tests, and the set_has
      // probes. The previous shape canonicalized every element up to
      // THREE times per slot — ~1.2us per labels/annotations entry on
      // the admission walk. (Element canons themselves are memoized on
      // the CVal nodes, so repeat visits copy cached strings.)
      ecs.reserve(v->elems.size());
      for (const CVal *e : v->elems) {
        std::string ec;
        canon_cval(e, ec);  // element canons memoized on the nodes
        ecs.push_back(std::move(ec));
      }
      if (v->canon_done) {
        // set-level canon already memoized (another slot visited this
        // node): reuse it — but STILL sort+dedupe ecs so the set_has /
        // dyn membership probes see exactly what the first-visit path
        // (canon_set_into) sees: a duplicated JSON element must push
        // each matching lit ONCE, in the same deterministic order, on
        // every visit and on the Python lane alike
        std::sort(ecs.begin(), ecs.end());
        ecs.erase(std::unique(ecs.begin(), ecs.end()), ecs.end());
        vcanon += v->canon;
      } else {
        canon_set_into(vcanon, ecs);
        CVal *m = const_cast<CVal *>(v);
        m->canon = vcanon;
        m->canon_done = true;
      }
    } else if (v) {
      // no per-element consumers: the memoized node canon covers sets too
      canon_cval(v, vcanon);
    }
    if (!s.dyns.empty()) {
      auto slot_canon = [&f](uint8_t var, const std::vector<std::string> &c,
                             std::string &out) {
        const CVal *sroot = var == 0   ? f.p_rec
                            : var == 2 ? f.res
                            : var == 3 ? f.ctx
                                       : nullptr;
        const CVal *sval = sroot ? cval_nav(sroot, c) : nullptr;
        if (!sval) return false;
        canon_cval(sval, out);
        return true;
      };
      eval_dyns(s, want_elems ? &ecs : nullptr, v ? &vcanon : nullptr,
                slot_canon, extras, scratch);
    }
    if (!v) continue;
    const int32_t *row = sv_find(s.vocab, vcanon);
    if (row) {
      codes[s.sidx] = *row;
    } else {
      codes[s.sidx] = s.present_row;
      if (v->kind == CVal::STRV) {
        for (const auto &lt : s.likes)
          if (like_match(lt.comps, v->str)) extras.push(lt.lit);
      } else if (v->kind == CVal::LONGV) {
        for (const auto &ct : s.cmps) {
          int64_t x = v->l;
          bool hit = ct.op == 0   ? x < ct.c
                     : ct.op == 1 ? x <= ct.c
                     : ct.op == 2 ? x > ct.c
                                  : x >= ct.c;
          if (hit) extras.push(ct.lit);
        }
      }
      if (!s.type_errs.empty()) {
        // mirror compiler/encode.value_tag over the CVal kinds
        uint8_t tag;
        switch (v->kind) {
          case CVal::STRV: tag = 's'; break;
          case CVal::LONGV: tag = 'l'; break;
          case CVal::BOOLV: tag = 'b'; break;
          case CVal::IPV: tag = 'i'; break;
          case CVal::SETV: tag = 'S'; break;
          case CVal::RECV: tag = 'R'; break;
          case CVal::ENTV: tag = 'e'; break;
          default: tag = '?'; break;
        }
        for (const auto &te : s.type_errs)
          if (te.want != tag) extras.push(te.lit);
      }
    }
    if (is_set && !s.set_has.empty()) {
      for (const auto &ec : ecs) {  // canons already built above
        const auto *lits = sv_find(s.set_has, ec);
        if (lits)
          for (int32_t lid : *lits) extras.push(lid);
      }
    }
  }
}

// Strict UTF-8 validation (RFC 3629, including overlong/surrogate/range
// rejection). The Python lane refuses most invalid UTF-8 (CPython's json
// decodes bytes with errors="surrogatepass": surrogate ENCODINGS are
// accepted there, everything else invalid raises), while this parser is
// byte-preserving — without this gate the same bytes could EVALUATE on
// the native lane and decode-error on the Python lane, making the
// decision depend on which lane a row takes. This gate is deliberately a
// superset of Python's rejection: flagged rows (including the surrogate
// class Python would accept) re-run through the Python fallback, which
// returns the Python lane's own verdict — parity holds either way. One
// pass over ~250-byte bodies: negligible next to the parse. (Found by
// the round-5 byte-mutation fuzz.)
bool utf8_valid(const uint8_t *p, size_t n) {
  size_t i = 0;
  while (i < n) {
    // ASCII fast path: 8 bytes per iteration while no high bit is set
    // (JSON bodies are overwhelmingly ASCII — this keeps the gate's cost
    // near one load per 8 bytes)
    while (i + 8 <= n) {
      uint64_t w;
      memcpy(&w, p + i, 8);
      if (w & 0x8080808080808080ull) break;
      i += 8;
    }
    if (i >= n) break;
    uint8_t b = p[i];
    if (b < 0x80) {
      ++i;
      continue;
    }
    size_t need;
    uint32_t cp;
    if ((b & 0xE0) == 0xC0) {
      need = 1;
      cp = b & 0x1Fu;
    } else if ((b & 0xF0) == 0xE0) {
      need = 2;
      cp = b & 0x0Fu;
    } else if ((b & 0xF8) == 0xF0) {
      need = 3;
      cp = b & 0x07u;
    } else {
      return false;  // continuation byte in lead position / 0xF8+
    }
    if (i + need >= n) return false;  // truncated sequence
    for (size_t k = 1; k <= need; ++k) {
      uint8_t c = p[i + k];
      if ((c & 0xC0) != 0x80) return false;
      cp = (cp << 6) | (c & 0x3Fu);
    }
    if (need == 1 && cp < 0x80) return false;                    // overlong
    if (need == 2 && (cp < 0x800 || (cp - 0xD800u) < 0x800u)) return false;
    if (need == 3 && (cp < 0x10000 || cp > 0x10FFFF)) return false;
    i += need + 1;
  }
  return true;
}

// One request's raw bytes, independent of how the batch arrived (packed
// buffer + offsets from ctypes, or per-item PyBytes pointers from the
// GIL-side harvest in the *_pylist entries).
struct ReqView {
  const uint8_t *p;
  uint64_t len;
};

// Persistent encode worker pool. The original drive_batch spawned fresh
// std::threads per batch — ~20-60us of clone/join overhead per call,
// which at serving chunk cadence (a few ms per 16k-row chunk, dozens of
// chunks/sec) ate a measurable slice of the encode budget and thrashed
// the scheduler. Workers here are created ONCE (growing to the largest
// thread count ever requested, capped), parked on a condition variable
// between batches, and handed (lo, hi) shard ranges through a shared
// cursor; the CALLING thread always runs one shard itself, so a pool of
// nt-1 workers serves an nt-way encode and a cold pool costs nothing on
// the first single-threaded call.
//
// Lifetime: the pool object is intentionally leaked (never destroyed).
// Workers blocked on the cv at process exit are reaped by _exit — unlike
// a joinable-thread destructor (std::terminate) or a pthread unwinding
// mid-C++-exception (the XLA warm-thread abort this codebase already
// guards against), a parked worker holds no lock and touches no state.
class EncodePool {
 public:
  static constexpr int kMaxWorkers = 64;

  // Run work(lo, hi) over [0, n) split into `shards` contiguous ranges,
  // the calling thread pulling shards alongside the pool workers. Blocks
  // until every shard completed. Thread-safe across concurrent callers
  // (each call owns a private Job; workers pull from the active job
  // queue). A busy or undersized pool degrades to the caller running
  // more shards itself — never to a deadlock or an unserved range.
  void run(uint64_t n, uint64_t shards,
           const std::function<void(uint64_t, uint64_t)> &work) {
    if (shards > n) shards = n;
    if (shards <= 1) {
      work(0, n);
      return;
    }
    ensure_workers(size_t(shards - 1));
    auto job = std::make_shared<Job>();
    job->work = &work;
    job->n = n;
    job->chunk = (n + shards - 1) / shards;
    job->next.store(0);
    {
      std::lock_guard<std::mutex> g(mu_);
      jobs_.push_back(job);
    }
    cv_work_.notify_all();
    while (run_one_shard(*job)) {
    }
    // every range is claimed INSIDE a pending window (run_one_shard
    // increments pending before touching the cursor), so pending == 0
    // with a drained cursor proves no shard — claimed or about to be
    // claimed — can still call `work` after this wait returns
    std::unique_lock<std::mutex> lk(job->mu);
    job->cv_done.wait(lk, [&] { return job->pending == 0 && job->drained; });
  }

 private:
  struct Job {
    const std::function<void(uint64_t, uint64_t)> *work;
    uint64_t n, chunk;
    std::atomic<uint64_t> next;
    std::mutex mu;
    std::condition_variable cv_done;
    int pending = 0;       // threads inside run_one_shard's claim window
    bool drained = false;  // cursor exhausted (job unlinked from queue)
  };

  // Claim + run the next range of `job`; false when the cursor is dry.
  // pending is raised BEFORE the cursor read: a thread holding a valid
  // range is always visible to run()'s completion wait (the gap between
  // fetch_add and a later increment would let run() return — and destroy
  // `work` — while this thread still intends to call it).
  bool run_one_shard(Job &job) {
    {
      std::lock_guard<std::mutex> g(job.mu);
      ++job.pending;
    }
    uint64_t lo = job.next.fetch_add(job.chunk);
    bool ran = lo < job.n;
    if (ran) {
      uint64_t hi = lo + job.chunk > job.n ? job.n : lo + job.chunk;
      (*job.work)(lo, hi);
    } else {
      unlink_job(job);
    }
    bool notify = false;
    {
      std::lock_guard<std::mutex> g(job.mu);
      --job.pending;
      notify = job.pending == 0 && job.drained;
    }
    if (notify) job.cv_done.notify_all();
    return ran;
  }

  void unlink_job(Job &job) {
    // first thread to see the dry cursor unlinks the job so workers stop
    // considering it (idempotent: late observers find nothing to erase)
    {
      std::lock_guard<std::mutex> g(mu_);
      for (size_t i = 0; i < jobs_.size(); ++i) {
        if (jobs_[i].get() == &job) {
          jobs_.erase(jobs_.begin() + i);
          break;
        }
      }
    }
    std::lock_guard<std::mutex> g(job.mu);
    job.drained = true;
  }

  void ensure_workers(size_t want) {
    if (want > kMaxWorkers) want = kMaxWorkers;
    std::lock_guard<std::mutex> g(mu_);
    while (n_workers_ < want) {
      std::thread([this] { worker_loop(); }).detach();
      ++n_workers_;
    }
  }

  void worker_loop() {
    for (;;) {
      std::shared_ptr<Job> job;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_work_.wait(lk, [&] { return !jobs_.empty(); });
        job = jobs_.front();  // shared_ptr copy: outlives run()'s return
      }
      // pull shards until this job's cursor runs dry; other queued jobs
      // are picked up on the next loop. A stale job (drained between the
      // copy and here) reads a dry cursor and never touches job->work.
      while (run_one_shard(*job)) {
      }
    }
  }

  std::mutex mu_;
  std::condition_variable cv_work_;
  std::vector<std::shared_ptr<Job>> jobs_;
  size_t n_workers_ = 0;
};

EncodePool &encode_pool() {
  static EncodePool *pool = new EncodePool();  // leaked on purpose
  return *pool;
}

// Shared batch threading driver: split [0, n) into n_threads contiguous
// ranges (per-thread arenas/pools live inside `work`), executed on the
// persistent pool (the calling thread runs shards too).
template <class Work>
void drive_batch(uint64_t n, int32_t n_threads, Work &&work) {
  if (n_threads <= 1 || n < 64) {
    work(uint64_t(0), n);
    return;
  }
  const std::function<void(uint64_t, uint64_t)> fn = work;
  encode_pool().run(n, uint64_t(n_threads), fn);
}

// SAR encode over a request range. extras_pad >= 0 means the extras
// buffer arrived UNinitialized (np.empty): fill every row's unused cells
// up to extras_cap so outputs stay deterministic — batch results must be
// bit-identical regardless of entry point or thread count
// (tests/test_torch_native.py pins this).
void encode_sar_rows(const Table &t, const ReqView *reqs, uint64_t lo,
                     uint64_t hi, int32_t *codes, int32_t *extras,
                     int32_t extras_cap, int32_t extras_pad,
                     int32_t *extras_count, uint8_t *flags) {
  Arena arena;
  Features f;
  std::string scratch;
  for (uint64_t i = lo; i < hi; ++i) {
    int32_t *c = codes + i * uint64_t(t.n_slots);
    ExtrasOut eo{extras + i * uint64_t(extras_cap), extras_cap};
    arena.reset();
    uint8_t flag;
    if (!reqs[i].p || !utf8_valid(reqs[i].p, size_t(reqs[i].len))) {
      // python-lane parity: invalid UTF-8 is a decode error, never an
      // evaluated request (see utf8_valid); a null view (non-bytes list
      // item) is likewise a decode error for the python lane to report
      flag = F_PARSE_ERROR;
    } else {
      JsonParser parser((const char *)reqs[i].p, size_t(reqs[i].len),
                        arena);
      JVal *root = parser.parse();
      if (!root || root->kind != JVal::OBJ) {
        flag = F_PARSE_ERROR;
      } else {
        f.reset();
        flag = build_features(root, f);
      }
    }
    if (flag != F_OK) {
      for (int32_t s = 0; s < t.n_slots; ++s) c[s] = 0;
      extras_count[i] = 0;
      flags[i] = flag;
    } else {
      encode_one(t, f, c, eo, scratch);
      extras_count[i] = eo.n;
      flags[i] = eo.overflow ? F_EXTRAS_OVERFLOW : F_OK;
    }
    if (extras_pad >= 0)
      for (int32_t k = eo.n; k < extras_cap; ++k) eo.buf[k] = extras_pad;
  }
}

// Admission encode over a request range (see ce_encode_adm_batch for the
// uids contract); extras_pad semantics as encode_sar_rows (fill EVERY
// row's unused cells: outputs stay deterministic across entry points).
void encode_adm_rows(const Table &t, const ReqView *reqs, uint64_t lo,
                     uint64_t hi, int32_t *codes, int32_t *extras,
                     int32_t extras_cap, int32_t extras_pad,
                     int32_t *extras_count, uint8_t *flags, char *uids,
                     int32_t *uid_lens) {
  Arena arena;
  CPool cpool;
  AdmFeatures f;
  std::string scratch;
  for (uint64_t i = lo; i < hi; ++i) {
    int32_t *c = codes + i * uint64_t(t.n_slots);
    ExtrasOut eo{extras + i * uint64_t(extras_cap), extras_cap};
    extras_count[i] = 0;
    uid_lens[i] = 0;
    arena.reset();
    cpool.reset();
    uint8_t flag = F_OK;
    if (!reqs[i].p || !utf8_valid(reqs[i].p, size_t(reqs[i].len))) {
      // python-lane parity: invalid UTF-8 is a decode error (utf8_valid);
      // null view (non-bytes list item) likewise
      flag = F_PARSE_ERROR;
    } else {
      JsonParser parser((const char *)reqs[i].p, size_t(reqs[i].len),
                        arena);
      JVal *root = parser.parse();
      if (!root || root->kind != JVal::OBJ) {
        flag = F_PARSE_ERROR;
      } else {
        f.reset();
        AdmCtx ctx;
        ctx.cp = &cpool;
        flag = build_adm(root, f, ctx, arena);
      }
    }
    if (flag != F_OK) {
      for (int32_t s = 0; s < t.n_slots; ++s) c[s] = 0;
      flags[i] = flag;
      if (flag == F_ADM_NS_SKIP) {
        memcpy(uids + i * 256, f.uid.data(), f.uid.size());
        uid_lens[i] = int32_t(f.uid.size());
      }
    } else {
      encode_adm_one(t, f, c, eo, scratch);
      extras_count[i] = eo.n;
      flags[i] = eo.overflow ? F_EXTRAS_OVERFLOW : F_OK;
      memcpy(uids + i * 256, f.uid.data(), f.uid.size());
      uid_lens[i] = int32_t(f.uid.size());
    }
    if (extras_pad >= 0)
      for (int32_t k = eo.n; k < extras_cap; ++k) eo.buf[k] = extras_pad;
  }
}

std::vector<ReqView> views_from_offsets(uint64_t n, const uint8_t *buf,
                                        const uint64_t *offsets,
                                        const uint64_t *lens) {
  std::vector<ReqView> reqs(n);
  for (uint64_t i = 0; i < n; ++i) reqs[i] = {buf + offsets[i], lens[i]};
  return reqs;
}

#ifdef CEDAR_PY_GLUE
// GIL-side harvest of a Python list of bytes-like objects into ReqViews.
// The Py_buffer views are HELD for the duration of the encode (release()
// under the GIL afterwards): an exported buffer pins bytearray /
// memoryview storage — resizing raises BufferError instead of
// invalidating the pointers the nogil worker threads are parsing. The
// caller-supplied `n` (the Python-side allocation size) caps the row
// count: a list mutated concurrently with the call can never overflow
// the caller's output arrays. Non-buffer items yield a null view ->
// F_PARSE_ERROR -> python fallback reports the exact decode error.
struct PyListViews {
  std::vector<ReqView> reqs;
  std::vector<Py_buffer> held;

  PyListViews(PyObject *list, uint64_t n_cap) {
    Py_ssize_t n = PyList_GET_SIZE(list);
    if (uint64_t(n) > n_cap) n = Py_ssize_t(n_cap);
    reqs.resize(static_cast<size_t>(n), ReqView{nullptr, 0});
    held.reserve(static_cast<size_t>(n));
    for (Py_ssize_t i = 0; i < n; ++i) {
      PyObject *o = PyList_GET_ITEM(list, i);  // borrowed
      Py_buffer vb;
      if (PyObject_GetBuffer(o, &vb, PyBUF_SIMPLE) != 0) {
        PyErr_Clear();
        continue;
      }
      reqs[size_t(i)] = {(const uint8_t *)vb.buf, uint64_t(vb.len)};
      held.push_back(vb);
    }
  }
  // GIL must be held
  void release() {
    for (auto &vb : held) PyBuffer_Release(&vb);
    held.clear();
  }
};
#endif  // CEDAR_PY_GLUE

}  // namespace

// ------------------------------------------------------------------ C API

extern "C" {

void *ce_load_table(const uint8_t *blob, uint64_t len) {
  return load_table(blob, size_t(len));
}

void ce_free_table(void *handle) { delete static_cast<Table *>(handle); }

// bodies are packed back to back in `buf`; request i spans
// [offsets[i], offsets[i] + lens[i]). codes: [n, n_slots] int32 (row
// indices); extras: [n, extras_cap] int32 pre-filled by the CALLER with the
// pad value; extras_count: [n] int32; flags: [n] uint8 (see F_* above).
void ce_encode_sar_batch(void *handle, uint64_t n, const uint8_t *buf,
                         const uint64_t *offsets, const uint64_t *lens,
                         int32_t *codes, int32_t *extras, int32_t extras_cap,
                         int32_t *extras_count, uint8_t *flags,
                         int32_t n_threads) {
  const Table &t = *static_cast<Table *>(handle);
  auto reqs = views_from_offsets(n, buf, offsets, lens);
  drive_batch(n, n_threads, [&](uint64_t lo, uint64_t hi) {
    encode_sar_rows(t, reqs.data(), lo, hi, codes, extras, extras_cap,
                    /*extras_pad=*/-1, extras_count, flags);
  });
}

int32_t ce_n_slots(void *handle) {
  return static_cast<Table *>(handle)->n_slots;
}

// AdmissionReview variant of ce_encode_sar_batch. Additional outputs: the
// review uid of each request is copied into uids[i * 256 .. ] (uid_lens[i]
// bytes) for F_OK / F_ADM_NS_SKIP rows so the caller can build responses
// without re-parsing; fallback rows (parse error / F_ADM_ERROR / overflow)
// re-run through the exact Python path instead.
void ce_encode_adm_batch(void *handle, uint64_t n, const uint8_t *buf,
                         const uint64_t *offsets, const uint64_t *lens,
                         int32_t *codes, int32_t *extras, int32_t extras_cap,
                         int32_t *extras_count, uint8_t *flags, char *uids,
                         int32_t *uid_lens, int32_t n_threads) {
  const Table &t = *static_cast<Table *>(handle);
  auto reqs = views_from_offsets(n, buf, offsets, lens);
  drive_batch(n, n_threads, [&](uint64_t lo, uint64_t hi) {
    encode_adm_rows(t, reqs.data(), lo, hi, codes, extras, extras_cap,
                    /*extras_pad=*/-1, extras_count, flags, uids, uid_lens);
  });
}

#ifdef CEDAR_PY_GLUE

// Python-list variants: called through a PyDLL view (GIL HELD on entry).
// The bodies list is harvested into pinned buffer views under the GIL,
// the GIL is released for the threaded encode, then the views release
// back under the GIL (see PyListViews for the lifetime argument).
// `n_alloc` is the caller's output-array row count — the hard cap on how
// many rows are encoded. `extras` arrives UNinitialized (np.empty);
// every row is pad-filled in C (extras_pad).
void ce_encode_sar_pylist(void *handle, PyObject *list, uint64_t n_alloc,
                          int32_t *codes, int32_t *extras,
                          int32_t extras_cap, int32_t extras_pad,
                          int32_t *extras_count, uint8_t *flags,
                          int32_t n_threads) {
  const Table &t = *static_cast<Table *>(handle);
  PyListViews views(list, n_alloc);
  uint64_t n = views.reqs.size();
  // if the list shrank concurrently, the trailing output rows would
  // otherwise stay np.empty garbage: make them deterministic error rows
  for (uint64_t i = n; i < n_alloc; ++i) {
    for (int32_t s = 0; s < t.n_slots; ++s) codes[i * t.n_slots + s] = 0;
    for (int32_t k = 0; k < extras_cap; ++k)
      extras[i * uint64_t(extras_cap) + k] = extras_pad;
    extras_count[i] = 0;
    flags[i] = F_PARSE_ERROR;
  }
  PyThreadState *st = PyEval_SaveThread();
  drive_batch(n, n_threads, [&](uint64_t lo, uint64_t hi) {
    encode_sar_rows(t, views.reqs.data(), lo, hi, codes, extras,
                    extras_cap, extras_pad, extras_count, flags);
  });
  PyEval_RestoreThread(st);
  views.release();
}

void ce_encode_adm_pylist(void *handle, PyObject *list, uint64_t n_alloc,
                          int32_t *codes, int32_t *extras,
                          int32_t extras_cap, int32_t extras_pad,
                          int32_t *extras_count, uint8_t *flags, char *uids,
                          int32_t *uid_lens, int32_t n_threads) {
  const Table &t = *static_cast<Table *>(handle);
  PyListViews views(list, n_alloc);
  uint64_t n = views.reqs.size();
  for (uint64_t i = n; i < n_alloc; ++i) {  // see SAR twin
    for (int32_t s = 0; s < t.n_slots; ++s) codes[i * t.n_slots + s] = 0;
    for (int32_t k = 0; k < extras_cap; ++k)
      extras[i * uint64_t(extras_cap) + k] = extras_pad;
    extras_count[i] = 0;
    uid_lens[i] = 0;
    flags[i] = F_PARSE_ERROR;
  }
  PyThreadState *st = PyEval_SaveThread();
  drive_batch(n, n_threads, [&](uint64_t lo, uint64_t hi) {
    encode_adm_rows(t, views.reqs.data(), lo, hi, codes, extras,
                    extras_cap, extras_pad, extras_count, flags, uids,
                    uid_lens);
  });
  PyEval_RestoreThread(st);
  views.release();
}

#endif  // CEDAR_PY_GLUE

}  // extern "C"
