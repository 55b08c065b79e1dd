// Native host runtime for multiz_tpu: the hot host-side paths around the
// device DP kernel, as a CPython extension (buffer protocol only — no
// numpy C API, so it builds with just g++ + Python headers).
//
// The reference implements these in C as part of its single address space
// (mz_yama.c:257-313 traceback + rebuild; the per-cell stats gathering is
// implicit in its K*L inner loops). Here they are the host runtime feeding
// the TPU kernel:
//   * colstats_into — per-column base histograms / dash counts / adjacent
//     dash-pair counts, written straight into the pre-allocated stacked
//     batch operands (zero-copy bucket packing).
//   * traceback_into — edit-script extraction over the flag matrix
//     (mz_yama.c:257-291), for the host oracle path.
//   * replay_into — edit script -> merged (K+L)-row column matrix
//     (mz_yama.c:294-309).
//   * pack_wire_into, replay_payload — the DP stream's wire buffer of a
//     bucket and the replay of a launch's payload, one call a launch.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <memory>
#include <vector>

namespace {

constexpr uint8_t FLAG_C = 0;
constexpr uint8_t FLAG_I = 1;
constexpr uint8_t FLAG_D = 2;
constexpr uint8_t SELECT_CID = 3;
constexpr uint8_t DASH = '-';

struct Buf {
    Py_buffer view{};
    bool ok = false;
    Buf(PyObject* obj, int flags) { ok = PyObject_GetBuffer(obj, &view, flags) == 0; }
    ~Buf() { if (ok) PyBuffer_Release(&view); }
    uint8_t* u8() const { return static_cast<uint8_t*>(view.buf); }
    int32_t* i32() const { return static_cast<int32_t*>(view.buf); }
    Py_ssize_t len() const { return view.len; }
};

// colstats_into(X, ncol, nrow, cat, hist, nond, ndash, pair)
//   X:    uint8 (ncol, nrow) C-contiguous
//   cat:  int8[256] byte -> category (6 categories)
//   hist: int32 (pad, 6); nond/ndash: int32 (pad,); pair: int32 (pad, 4)
// Rows 1..ncol are written; row 0 and padding are left untouched.
PyObject* colstats_into(PyObject*, PyObject* args) {
    PyObject *xo, *cato, *histo, *nondo, *ndasho, *pairo;
    Py_ssize_t ncol, nrow;
    if (!PyArg_ParseTuple(args, "OnnOOOOO", &xo, &ncol, &nrow, &cato,
                          &histo, &nondo, &ndasho, &pairo))
        return nullptr;
    Buf X(xo, PyBUF_SIMPLE), cat(cato, PyBUF_SIMPLE);
    Buf hist(histo, PyBUF_WRITABLE), nond(nondo, PyBUF_WRITABLE),
        ndash(ndasho, PyBUF_WRITABLE), pair(pairo, PyBUF_WRITABLE);
    if (!X.ok || !cat.ok || !hist.ok || !nond.ok || !ndash.ok || !pair.ok)
        return nullptr;
    if (X.len() < ncol * nrow || cat.len() < 256) {
        PyErr_SetString(PyExc_ValueError, "colstats_into: bad buffer sizes");
        return nullptr;
    }
    const uint8_t* x = X.u8();
    const int8_t* c8 = reinterpret_cast<const int8_t*>(cat.u8());
    int32_t* h = hist.i32();
    int32_t* n0 = nond.i32();
    int32_t* n1 = ndash.i32();
    int32_t* pr = pair.i32();
    for (Py_ssize_t i = 1; i <= ncol; ++i) {
        const uint8_t* col = x + (i - 1) * nrow;
        int32_t hc[6] = {0, 0, 0, 0, 0, 0};
        int32_t dash = 0;
        for (Py_ssize_t r = 0; r < nrow; ++r) {
            uint8_t b = col[r];
            hc[c8[b]] += 1;
            dash += (b == DASH);
        }
        for (int k = 0; k < 6; ++k) h[i * 6 + k] = hc[k];
        n1[i] = dash;
        n0[i] = (int32_t)nrow - dash;
        if (i == 1) {
            pr[4 + 0] = n0[1];
            pr[4 + 1] = n1[1];
            pr[4 + 2] = 0;
            pr[4 + 3] = 0;
        } else {
            const uint8_t* prev = col - nrow;
            int32_t p[4] = {0, 0, 0, 0};
            for (Py_ssize_t r = 0; r < nrow; ++r) {
                int f = prev[r] == DASH;
                int s = col[r] == DASH;
                p[(f << 1) | s] += 1;
            }
            for (int k = 0; k < 4; ++k) pr[i * 4 + k] = p[k];
        }
    }
    Py_RETURN_NONE;
}

// traceback_into(flags, M, N, C, D, I, script_out) -> nedit
//   flags: uint8 (M+1, N+1) C-contiguous; script_out: uint8 (M+N,)
//   Writes ops newest-first (walking back from (M,N)), like the C's
//   script buffer before reversal (mz_yama.c:257-291).
PyObject* traceback_into(PyObject*, PyObject* args) {
    PyObject *fo, *so;
    Py_ssize_t M, N;
    long C, D, I;
    if (!PyArg_ParseTuple(args, "OnnlllO", &fo, &M, &N, &C, &D, &I, &so))
        return nullptr;
    Buf F(fo, PyBUF_SIMPLE), S(so, PyBUF_WRITABLE);
    if (!F.ok || !S.ok) return nullptr;
    if (F.len() < (M + 1) * (N + 1) || S.len() < M + N) {
        PyErr_SetString(PyExc_ValueError, "traceback_into: bad buffer sizes");
        return nullptr;
    }
    const uint8_t* flags = F.u8();
    uint8_t* script = S.u8();
    const Py_ssize_t ld = N + 1;
    uint8_t node;
    if (C >= D && C >= I) node = FLAG_C;
    else if (D >= I) node = FLAG_D;
    else node = FLAG_I;
    Py_ssize_t row = M, col = N, nedit = 0;
    while (row > 0 || col > 0) {
        if (row < 0 || col < 0) {
            PyErr_SetString(PyExc_ValueError, "Error generating edit script.");
            return nullptr;
        }
        uint8_t st = flags[row * ld + col];
        script[nedit++] = node;
        if (node == FLAG_I) {
            col -= 1;
            node = st >> 4;
        } else if (node == FLAG_D) {
            row -= 1;
            node = (st >> 2) & SELECT_CID;
        } else if (node == FLAG_C) {
            row -= 1;
            col -= 1;
            node = st & SELECT_CID;
        } else {
            PyErr_SetString(PyExc_ValueError, "illegal node type in traceback");
            return nullptr;
        }
    }
    return PyLong_FromSsize_t(nedit);
}

// n bytes of a column (a block's rows: a few) copied, or set to DASH,
// by fixed-size moves in place of a library call a row.
inline void put_col(uint8_t* d, const uint8_t* s, Py_ssize_t n) {
    switch (n) {
        case 1: d[0] = s[0]; return;
        case 2: std::memcpy(d, s, 2); return;
        case 3: std::memcpy(d, s, 2); d[2] = s[2]; return;
        case 4: std::memcpy(d, s, 4); return;
        case 5: std::memcpy(d, s, 4); d[4] = s[4]; return;
        case 6: std::memcpy(d, s, 4); std::memcpy(d + 4, s + 4, 2); return;
        case 7: std::memcpy(d, s, 4); std::memcpy(d + 3, s + 3, 4); return;
        case 8: std::memcpy(d, s, 8); return;
        default: std::memcpy(d, s, n);
    }
}

inline void dash_col(uint8_t* d, Py_ssize_t n) {
    static const uint8_t dashes[8] = {DASH, DASH, DASH, DASH,
                                      DASH, DASH, DASH, DASH};
    if (n <= 8) put_col(d, dashes, n);
    else std::memset(d, DASH, n);
}

// The merged (n, K+L) column matrix of one job (mz_yama.c:294-309): row
// t takes op(t) (C, D or I, oldest first). A: (M, K), B: (N, L), both
// C-contiguous. false where the ops do not consume A and B exactly.
template <class Op>
bool replay_rows(Op op, Py_ssize_t n, const uint8_t* a, Py_ssize_t M,
                 Py_ssize_t K, const uint8_t* b, Py_ssize_t N, Py_ssize_t L,
                 uint8_t* out) {
    const Py_ssize_t W = K + L;
    Py_ssize_t ai = 0, bi = 0;
    for (Py_ssize_t t = 0; t < n; ++t) {
        const uint8_t o = op(t);
        uint8_t* row = out + t * W;
        if (o != FLAG_I) {  // C or D consume a column of A
            if (ai >= M) return false;
            put_col(row, a + ai * K, K);
            ++ai;
        } else {
            dash_col(row, K);
        }
        if (o != FLAG_D) {  // C or I consume a column of B
            if (bi >= N) return false;
            put_col(row + K, b + bi * L, L);
            ++bi;
        } else {
            dash_col(row + K, L);
        }
    }
    return ai == M && bi == N;
}

const char* const NOT_EXACT =
    "new_align: script does not consume A and B exactly";

// replay_into(script, n, reversed, A, M, K, B, N, L, out)
//   script: uint8 ops; if reversed != 0 the ops are newest-first (walked
//   back-to-front), else oldest-first. A: (M, K) uint8; B: (N, L) uint8;
//   out: (n, K+L) uint8, fully overwritten.
PyObject* replay_into(PyObject*, PyObject* args) {
    PyObject *so, *ao, *bo, *oo;
    Py_ssize_t n, M, K, N, L;
    int reversed_;
    if (!PyArg_ParseTuple(args, "OnpOnnOnnO", &so, &n, &reversed_, &ao, &M,
                          &K, &bo, &N, &L, &oo))
        return nullptr;
    Buf S(so, PyBUF_SIMPLE), A(ao, PyBUF_SIMPLE), B(bo, PyBUF_SIMPLE),
        O(oo, PyBUF_WRITABLE);
    if (!S.ok || !A.ok || !B.ok || !O.ok) return nullptr;
    if (S.len() < n || A.len() < M * K || B.len() < N * L ||
        O.len() < n * (K + L)) {
        PyErr_SetString(PyExc_ValueError, "replay_into: bad buffer sizes");
        return nullptr;
    }
    const uint8_t* script = S.u8();
    auto op = [&](Py_ssize_t t) { return script[reversed_ ? n - 1 - t : t]; };
    if (!replay_rows(op, n, A.u8(), M, K, B.u8(), N, L, O.u8())) {
        PyErr_SetString(PyExc_ValueError, NOT_EXACT);
        return nullptr;
    }
    Py_RETURN_NONE;
}

// Sum-of-pairs score of columns [start, start+size) of n rows of equal
// length (mafScoreRange, mz_scores.c:124-152), incl. the reference's
// quirk that the gap term for column i reaches back to absolute column
// i-1 even when i == start > 0. ss: int32 (128,128); gop: int32 (16,).
int64_t sop_score(const uint8_t* const* rows, Py_ssize_t n, Py_ssize_t start,
                  Py_ssize_t size, const int32_t* ss, const int32_t* gop) {
    const Py_ssize_t lo = start > 1 ? start : 1;
    const Py_ssize_t hi = start + size;
    int64_t total = 0;
    // Release the GIL only when the work is long enough to matter:
    // most calls score a few hundred columns (~microseconds), and
    // forfeiting the GIL there makes the calling thread queue behind
    // the host-DP lane worker for milliseconds per call (measured:
    // +27 us/call average under lane load).
    const bool big = (int64_t)size * n * (n - 1) > 200000;
    PyThreadState* _save = big ? PyEval_SaveThread() : nullptr;
    for (Py_ssize_t i = 0; i < n; ++i) {
        const uint8_t* a = rows[i];
        for (Py_ssize_t j = i + 1; j < n; ++j) {
            const uint8_t* b = rows[j];
            for (Py_ssize_t c = start; c < hi; ++c)
                total += ss[a[c] * 128 + b[c]];
            for (Py_ssize_t c = lo; c < hi; ++c) {
                int idx = ((a[c - 1] == DASH) << 3) |
                          ((b[c - 1] == DASH) << 2) |
                          ((a[c] == DASH) << 1) | (b[c] == DASH);
                total -= gop[idx];
            }
        }
    }
    if (_save) PyEval_RestoreThread(_save);
    return total;
}

// score_range(T, n, W, start, size, ss, gop) -> int64
//   sop_score over n stacked text rows. T: uint8 (n, W) C-contiguous.
PyObject* score_range(PyObject*, PyObject* args) {
    PyObject *to, *sso, *gopo;
    Py_ssize_t n, W, start, size;
    if (!PyArg_ParseTuple(args, "OnnnnOO", &to, &n, &W, &start, &size,
                          &sso, &gopo))
        return nullptr;
    Buf T(to, PyBUF_SIMPLE), SS(sso, PyBUF_SIMPLE), GOP(gopo, PyBUF_SIMPLE);
    if (!T.ok || !SS.ok || !GOP.ok) return nullptr;
    if (n < 0 || T.len() < n * W || start < 0 || size <= 0 ||
        start + size > W ||
        SS.len() < (Py_ssize_t)(128 * 128 * sizeof(int32_t)) ||
        GOP.len() < (Py_ssize_t)(16 * sizeof(int32_t))) {
        PyErr_SetString(PyExc_ValueError, "score_range: bad args");
        return nullptr;
    }
    std::vector<const uint8_t*> rows(n);
    for (Py_ssize_t i = 0; i < n; ++i) rows[i] = T.u8() + i * W;
    return PyLong_FromLongLong((long long)sop_score(
        rows.data(), n, start, size, SS.i32(), GOP.i32()));
}

// ---- block cuts of the merge scan (blocks.keep_ali, make_part_ali_col,
// nd_col): one pass over a block's rows a cut, in place of several numpy
// calls a row. Each answers or raises: a text that is not a 1-D byte
// buffer, rows of unequal length or a cut outside the rows raise.

// A buffer of R (1 or 2) dimensions of T (uint8_t: any one-byte format;
// int64_t) as C-ordered elements: read in place where it is C-contiguous,
// else gathered through its strides (copied once). rows is 1 where R is 1;
// n = rows * cols.
template <class T, int R>
struct Strided {
    static_assert(R == 1 || R == 2, "one or two dimensions");
    Py_buffer view{};
    bool got = false;
    std::vector<T> copy;
    const T* p = nullptr;
    Py_ssize_t rows = 1, cols = 0, n = 0;

    Strided() = default;
    Strided(const Strided&) = delete;
    Strided& operator=(const Strided&) = delete;
    ~Strided() { if (got) PyBuffer_Release(&view); }
    // false with an exception set (ValueError "<what> is not ..." where
    // the buffer has another rank or element type)
    bool load(PyObject* o, const char* what) {
        if (PyObject_GetBuffer(o, &view, PyBUF_RECORDS_RO) != 0) return false;
        got = true;
        if (view.ndim != R || view.itemsize != (Py_ssize_t)sizeof(T) ||
            !element_ok(view.format)) {
            PyErr_Format(PyExc_ValueError, "%s is not a %d-D %s array", what,
                         R, sizeof(T) == 1 ? "byte" : "int64");
            return false;
        }
        if (R == 2) rows = view.shape[0];
        cols = view.shape[R - 1];
        n = rows * cols;
        const Py_ssize_t s0 = R == 2 ? view.strides[0] : 0;
        const Py_ssize_t s1 = view.strides[R - 1];
        const char* b = static_cast<const char*>(view.buf);
        if ((cols <= 1 || s1 == (Py_ssize_t)sizeof(T)) &&
            (rows <= 1 || s0 == cols * (Py_ssize_t)sizeof(T))) {
            p = reinterpret_cast<const T*>(b);
            return true;
        }
        copy.resize(n);
        for (Py_ssize_t r = 0; r < rows; ++r)
            for (Py_ssize_t c = 0; c < cols; ++c)
                std::memcpy(&copy[r * cols + c], b + r * s0 + c * s1,
                            sizeof(T));
        p = copy.data();
        return true;
    }

  private:
    static bool element_ok(const char* f) {
        if (sizeof(T) == 1 || !f) return sizeof(T) == 1;
        if (*f == '@' || *f == '=' || *f == '<') ++f;
        return (f[0] == 'l' || f[0] == 'q') && f[1] == '\0';
    }
};

// A row's text as bytes.
using Text = Strided<uint8_t, 1>;
// A job's A or B (columns, rows), or a launch's payload.
using Mat = Strided<uint8_t, 2>;
// A band bound.
using Ints = Strided<int64_t, 1>;

// #non-dash bytes of p[0:n].
inline Py_ssize_t count_nondash(const uint8_t* p, Py_ssize_t n) {
    Py_ssize_t c = 0;
    for (Py_ssize_t i = 0; i < n; ++i) c += (p[i] != DASH);
    return c;
}

// Column of the k-th (0-based) non-dash byte of p[0:n] counted from the
// front (or from the back: k = 0 is the last), or -1. Whole 64-byte
// chunks are skipped by their count.
Py_ssize_t kth_nondash(const uint8_t* p, Py_ssize_t n, Py_ssize_t k,
                       bool back) {
    constexpr Py_ssize_t CH = 64;
    if (!back) {
        Py_ssize_t i = 0;
        for (; i + CH <= n; i += CH) {
            Py_ssize_t c = count_nondash(p + i, CH);
            if (c > k) break;
            k -= c;
        }
        for (; i < n; ++i)
            if (p[i] != DASH && k-- == 0) return i;
    } else {
        Py_ssize_t i = n;
        for (; i - CH >= 0; i -= CH) {
            Py_ssize_t c = count_nondash(p + i - CH, CH);
            if (c > k) break;
            k -= c;
        }
        while (i-- > 0)
            if (p[i] != DASH && k-- == 0) return i;
    }
    return -1;
}

// maf.Comp's slots, read and written through their member offsets, as
// its slot descriptors do, in place of an attribute lookup each: resolved
// once for Comp's type (the first one seen). Any other type, or one whose
// slots are not all object members, raises TypeError.
struct CompSlots {
    enum { TEXT, START, SIZE, SRC, STRAND, SRC_SIZE, PARALOG, PM, ND, N };
    PyTypeObject* tp = nullptr;
    Py_ssize_t off[N];

    // false with an exception set
    bool resolve(PyTypeObject* t) {
        if (t == tp) return true;
        if (tp) return refuse(t);
        static const char* names[N] = {"text", "start", "size", "src",
                                       "strand", "src_size", "paralog",
                                       "_pm", "_nd"};
        for (int i = 0; i < N; ++i) {
            PyObject* d = PyObject_GetAttrString((PyObject*)t, names[i]);
            bool ok = d && Py_IS_TYPE(d, &PyMemberDescr_Type);
            if (ok) {
                PyMemberDef* m = ((PyMemberDescrObject*)d)->d_member;
                ok = m->type == Py_T_OBJECT_EX && !(m->flags & Py_READONLY);
                off[i] = m->offset;
            }
            Py_XDECREF(d);
            if (!ok) {
                PyErr_Clear();
                return refuse(t);
            }
        }
        Py_INCREF(t);  // the offsets stay valid while the type lives
        tp = t;
        return true;
    }
    static bool refuse(PyTypeObject* t) {
        PyErr_Format(PyExc_TypeError, "%s is not maf.Comp", t->tp_name);
        return false;
    }
    // a slot's value, borrowed (nullptr where it is unset)
    PyObject* get(PyObject* o, int i) const {
        return *reinterpret_cast<PyObject**>(reinterpret_cast<char*>(o) + off[i]);
    }
    // store v (a new reference, stolen) in a slot
    void set(PyObject* o, int i, PyObject* v) const {
        PyObject** p =
            reinterpret_cast<PyObject**>(reinterpret_cast<char*>(o) + off[i]);
        PyObject* old = *p;
        *p = v;
        Py_XDECREF(old);
    }
} slots;

// The rows of a block as byte buffers (Text), each with its optional
// int64 position map (Comp.pos_map, held where it is current: pm[c] =
// #non-dash in text[:c+1]). A map of the wrong length is ignored.
struct Rows {
    std::unique_ptr<Text[]> text;
    std::vector<Py_buffer> pm;
    std::vector<char> has_pm;
    Py_ssize_t n = 0, W = -1;

    ~Rows() {
        for (Py_ssize_t i = 0; i < n; ++i)
            if (has_pm[i]) PyBuffer_Release(&pm[i]);
    }
    // false with an exception set
    bool load(PyObject* texts, PyObject* pms) {
        const Py_ssize_t m = PySequence_Fast_GET_SIZE(texts);
        if (m < 1 || PySequence_Fast_GET_SIZE(pms) != m) {
            PyErr_SetString(PyExc_ValueError,
                            "a block's rows and maps do not match");
            return false;
        }
        resize(m);
        for (Py_ssize_t i = 0; i < n; ++i) {
            if (!add(i, PySequence_Fast_GET_ITEM(texts, i))) return false;
            take_pm(i, PySequence_Fast_GET_ITEM(pms, i));
        }
        return true;
    }
    // The rows of a list of maf.Comps from row `from` on (none is fine),
    // each with its position map where it is current (Comp._pm).
    bool load_comps(PyObject* comps, Py_ssize_t from) {
        const Py_ssize_t m = PySequence_Fast_GET_SIZE(comps) - from;
        if (m < 0) {
            PyErr_SetString(PyExc_ValueError, "a block has too few rows");
            return false;
        }
        resize(m);
        for (Py_ssize_t i = 0; i < n; ++i) {
            PyObject* c = PySequence_Fast_GET_ITEM(comps, from + i);
            if (!slots.resolve(Py_TYPE(c))) return false;
            PyObject* t = slots.get(c, slots.TEXT);
            if (!t) {
                PyErr_SetString(PyExc_AttributeError, "a Comp has no text");
                return false;
            }
            if (!add(i, t)) return false;
            PyObject* m = slots.get(c, slots.PM);
            if (m && PyTuple_Check(m) && PyTuple_GET_SIZE(m) == 2 &&
                PyTuple_GET_ITEM(m, 0) == t)
                take_pm(i, PyTuple_GET_ITEM(m, 1));
        }
        return true;
    }
    const uint8_t* row(Py_ssize_t i) const { return text[i].p; }
    // #non-dash in row i's text[:col], 0 <= col <= W
    Py_ssize_t before(Py_ssize_t i, Py_ssize_t col) const {
        if (col <= 0) return 0;
        if (has_pm[i])
            return (Py_ssize_t)static_cast<const int64_t*>(pm[i].buf)[col - 1];
        return count_nondash(row(i), col);
    }

  private:
    void resize(Py_ssize_t m) {
        n = m;
        text.reset(new Text[m]);
        pm.resize(m);
        has_pm.assign(m, 0);
    }
    bool add(Py_ssize_t i, PyObject* t) {  // row i's text, of length W
        if (!text[i].load(t, "a row's text")) return false;
        if (W < 0) W = text[i].n;
        if (text[i].n != W) {
            PyErr_SetString(PyExc_ValueError, "a block's rows differ in length");
            return false;
        }
        return true;
    }
    void take_pm(Py_ssize_t i, PyObject* m) {  // row i's map, if it fits
        if (m == Py_None) return;
        if (PyObject_GetBuffer(m, &pm[i], PyBUF_SIMPLE) != 0) {
            PyErr_Clear();
            return;
        }
        if (pm[i].len == W * (Py_ssize_t)sizeof(int64_t))
            has_pm[i] = 1;
        else
            PyBuffer_Release(&pm[i]);
    }
};

// A sequence as a fast sequence (o is nullptr with the error set).
struct Fast {
    PyObject* o;
    explicit Fast(PyObject* seq) : o(PySequence_Fast(seq, "expected a sequence")) {}
    ~Fast() { Py_XDECREF(o); }
};

// keep_cut(texts, pms, nd, k) -> (col_beg, counts)
//   keep_ali's cut (multi_util.c:468-511): col_beg is the column just
//   after the top row's k-th non-dash char (0 where k == 0), found from
//   the top row's nd_idx (int64, or None) or its position map, else by a
//   scan; counts[i] is row i's #non-dash before col_beg. ValueError where
//   the top row holds fewer than k non-dash chars.
PyObject* keep_cut(PyObject*, PyObject* args) {
    PyObject *to, *pmo, *ndo;
    Py_ssize_t k;
    if (!PyArg_ParseTuple(args, "OOOn", &to, &pmo, &ndo, &k)) return nullptr;
    Fast texts(to), pms(pmo);
    if (!texts.o || !pms.o) return nullptr;
    Rows R;
    if (!R.load(texts.o, pms.o)) return nullptr;
    const Py_ssize_t W = R.W;
    Py_ssize_t col_beg = -1;
    if (k < 0) {
        col_beg = W + 1;  // no such char
    } else if (k == 0) {
        col_beg = 0;
    } else if (ndo != Py_None) {
        Buf nd(ndo, PyBUF_SIMPLE);
        if (!nd.ok) PyErr_Clear();
        else if (nd.len() >= k * (Py_ssize_t)sizeof(int64_t))
            col_beg = (Py_ssize_t)reinterpret_cast<const int64_t*>(nd.u8())[k - 1] + 1;
    }
    if (col_beg < 0 && R.has_pm[0]) {  // first column whose count reaches k
        const int64_t* pm = static_cast<const int64_t*>(R.pm[0].buf);
        Py_ssize_t lo = 0, hi = W;
        while (lo < hi) {
            Py_ssize_t mid = lo + (hi - lo) / 2;
            if (pm[mid] >= k) hi = mid; else lo = mid + 1;
        }
        if (lo < W) col_beg = lo + 1;
    }
    if (col_beg < 0) {
        Py_ssize_t c = kth_nondash(R.row(0), W, k - 1, false);
        if (c >= 0) col_beg = c + 1;
    }
    if (col_beg < 0 || col_beg > W) {
        PyErr_Format(PyExc_ValueError, "keep_cut: no non-dash char %zd", k);
        return nullptr;
    }
    PyObject* counts = PyList_New(R.n);
    if (!counts) return nullptr;
    for (Py_ssize_t i = 0; i < R.n; ++i)
        PyList_SET_ITEM(counts, i, PyLong_FromSsize_t(R.before(i, col_beg)));
    return Py_BuildValue("(nN)", col_beg, counts);
}

// part_cut(texts, pms, cbeg, cend, ss, gop) -> (befores, sizes, mask, score)
//   make_part_ali_col's cut (multi_util.c:570-617) of columns
//   [cbeg, cend]: each row's #non-dash before and inside them (a row
//   whose size is 0 is dropped), mask (bytes, 1 = keep) where a column
//   of the range is all dash, else None, and the sop_score of the kept
//   rows over the kept columns. ValueError where the range is empty or
//   leaves the rows.
PyObject* part_cut(PyObject*, PyObject* args) {
    PyObject *to, *pmo, *sso, *gopo;
    Py_ssize_t cbeg, cend;
    if (!PyArg_ParseTuple(args, "OOnnOO", &to, &pmo, &cbeg, &cend, &sso,
                          &gopo))
        return nullptr;
    Buf SS(sso, PyBUF_SIMPLE), GOP(gopo, PyBUF_SIMPLE);
    if (!SS.ok || !GOP.ok) return nullptr;
    if (SS.len() < (Py_ssize_t)(128 * 128 * sizeof(int32_t)) ||
        GOP.len() < (Py_ssize_t)(16 * sizeof(int32_t))) {
        PyErr_SetString(PyExc_ValueError, "part_cut: bad tables");
        return nullptr;
    }
    Fast texts(to), pms(pmo);
    if (!texts.o || !pms.o) return nullptr;
    Rows R;
    if (!R.load(texts.o, pms.o)) return nullptr;
    if (cbeg < 0 || cend < cbeg || cend >= R.W) {
        PyErr_Format(PyExc_ValueError, "part_cut: columns %zd-%zd of %zd",
                     cbeg, cend, R.W);
        return nullptr;
    }
    const Py_ssize_t width = cend - cbeg + 1;
    std::vector<Py_ssize_t> bef(R.n), sz(R.n);
    std::vector<const uint8_t*> kept;
    kept.reserve(R.n);
    for (Py_ssize_t i = 0; i < R.n; ++i) {
        const uint8_t* p = R.row(i) + cbeg;
        bef[i] = R.before(i, cbeg);
        sz[i] = R.has_pm[i] ? R.before(i, cend + 1) - bef[i]
                            : count_nondash(p, width);
        if (sz[i] > 0) kept.push_back(p);
    }
    const Py_ssize_t nk = (Py_ssize_t)kept.size();
    // columns of the range that hold a non-dash char in some row
    std::vector<uint8_t> keep(width, 0);
    Py_ssize_t wk = 0;
    for (Py_ssize_t c = 0; c < width; ++c) {
        uint8_t any = 0;
        for (Py_ssize_t i = 0; i < nk && !any; ++i) any = kept[i][c] != DASH;
        keep[c] = any;
        wk += any;
    }
    int64_t score = 0;
    std::vector<uint8_t> packed;  // the kept rows without all-dash columns
    if (nk >= 2 && wk > 0) {
        if (wk < width) {
            packed.resize(nk * wk);
            for (Py_ssize_t i = 0; i < nk; ++i) {
                uint8_t* q = packed.data() + i * wk;
                for (Py_ssize_t c = 0; c < width; ++c)
                    if (keep[c]) *q++ = kept[i][c];
                kept[i] = packed.data() + i * wk;
            }
        }
        score = sop_score(kept.data(), nk, 0, wk, SS.i32(), GOP.i32());
    }
    PyObject* befores = PyList_New(R.n);
    PyObject* sizes = PyList_New(R.n);
    PyObject* mask = wk < width
        ? PyBytes_FromStringAndSize(reinterpret_cast<const char*>(keep.data()), width)
        : (Py_INCREF(Py_None), Py_None);
    if (!befores || !sizes || !mask) {
        Py_XDECREF(befores);
        Py_XDECREF(sizes);
        Py_XDECREF(mask);
        return nullptr;
    }
    for (Py_ssize_t i = 0; i < R.n; ++i) {
        PyList_SET_ITEM(befores, i, PyLong_FromSsize_t(bef[i]));
        PyList_SET_ITEM(sizes, i, PyLong_FromSsize_t(sz[i]));
    }
    return Py_BuildValue("(NNNL)", befores, sizes, mask, (long long)score);
}

// Column of the k-th (0-based) non-dash byte of a row p[0:W] holding n
// of them (maf.pos2col), W where k == n, -1 where there is none: a scan
// from the row's nearer end.
Py_ssize_t nd_col_of(const uint8_t* p, Py_ssize_t W, Py_ssize_t k,
                     Py_ssize_t n) {
    if (k < 0 || k > n) return -1;
    if (k == n) return W;
    return k <= n - 1 - k ? kth_nondash(p, W, k, false)
                          : kth_nondash(p, W, n - 1 - k, true);
}

// nd_col(text, k, n) -> column
//   nd_col_of over a row, in place of nd_idx over the whole row.
//   ValueError where k is outside [0, n] or the row has no such char.
PyObject* nd_col(PyObject*, PyObject* args) {
    PyObject* to;
    Py_ssize_t k, n;
    if (!PyArg_ParseTuple(args, "Onn", &to, &k, &n)) return nullptr;
    Text T;
    if (!T.load(to, "a row's text")) return nullptr;
    Py_ssize_t c = nd_col_of(T.p, T.n, k, n);
    if (c < 0) {
        PyErr_Format(PyExc_ValueError, "nd_col: no non-dash char %zd of %zd",
                     k, n);
        return nullptr;
    }
    return PyLong_FromSsize_t(c);
}

// nondash_count(text, col) -> #non-dash in text[:col]
//   Comp.nondash_before without the row's position map: 0 where col <= 0,
//   IndexError where col is past the row.
PyObject* nondash_count(PyObject*, PyObject* args) {
    PyObject* to;
    Py_ssize_t col;
    if (!PyArg_ParseTuple(args, "On", &to, &col)) return nullptr;
    Text T;
    if (!T.load(to, "a row's text")) return nullptr;
    if (col > T.n) {
        PyErr_Format(PyExc_IndexError, "nondash_count: column %zd of %zd",
                     col, T.n);
        return nullptr;
    }
    return PyLong_FromSsize_t(col <= 0 ? 0 : count_nondash(T.p, col));
}

// band_info(LB, RB, M, N, row_chunk, cws) -> (cw, maxwidth, cells)
//   One pass over a job's band: entry validation (mz_yama.c:58-71),
//   window-ladder selection (yama_pack.route_band, the JAX stream's
//   admission rule) and band cell counting in the batched dispatch
//   admission loop. LB/RB int64 (>= M+1); cws: int64 ladder.
//   cw == 0 means no ladder width fits (host fallback).
PyObject* band_info(PyObject*, PyObject* args) {
    PyObject *lbo, *rbo, *cwso;
    Py_ssize_t M, N, RC;
    if (!PyArg_ParseTuple(args, "OOnnnO", &lbo, &rbo, &M, &N, &RC, &cwso))
        return nullptr;
    Buf LBb(lbo, PyBUF_SIMPLE), RBb(rbo, PyBUF_SIMPLE),
        CWS(cwso, PyBUF_SIMPLE);
    if (!LBb.ok || !RBb.ok || !CWS.ok) return nullptr;
    if (LBb.len() < (Py_ssize_t)((M + 1) * sizeof(int64_t)) ||
        RBb.len() < (Py_ssize_t)((M + 1) * sizeof(int64_t)) || RC < 1) {
        PyErr_SetString(PyExc_ValueError, "band_info: bad buffers");
        return nullptr;
    }
    const int64_t* LB = reinterpret_cast<const int64_t*>(LBb.u8());
    const int64_t* RB = reinterpret_cast<const int64_t*>(RBb.u8());
    const int64_t* cws = reinterpret_cast<const int64_t*>(CWS.u8());
    const Py_ssize_t ncw = CWS.len() / (Py_ssize_t)sizeof(int64_t);

    if (LB[0] != 0 || RB[M] != N) {
        PyErr_Format(PyExc_ValueError,
                     "LB and RB not terminated properly: %lld %lld %lld",
                     (long long)LB[0], (long long)RB[M], (long long)N);
        return nullptr;
    }
    const int64_t minw = N < 10 ? N : 10;
    int64_t width = 0, cells = 0, need = 0;
    // per-chunk window need: RB_max(chunk) + 1 - 128*floor(LB[r0]/128)
    for (Py_ssize_t t = 0, r = 0; r <= M; t++) {
        Py_ssize_t r0 = t * RC;
        if (r0 < 1) r0 = 1;
        if (r0 > M) r0 = M;
        int64_t w0 = (LB[r0] / 128) * 128;
        Py_ssize_t hi = t * RC + RC - 1;
        if (hi > M) hi = M;
        for (; r <= hi; ++r) {
            int64_t w = RB[r] - LB[r];
            if (w < minw) {
                PyErr_Format(PyExc_ValueError, "RB[%zd] - LB[%zd] < %lld",
                             r, r, (long long)minw);
                return nullptr;
            }
            if (r > 0 && (LB[r] < LB[r - 1] || RB[r] < RB[r - 1])) {
                PyErr_SetString(PyExc_ValueError, "band not monotonic");
                return nullptr;
            }
            if (w > width) width = w;
            int64_t rb = RB[r] < N ? RB[r] : N;
            cells += rb - LB[r];
            if (r >= 1) {  // the ladder skips chunks with lo > hi
                int64_t nd = RB[r] + 1 - w0;
                if (nd > need) need = nd;
            }
        }
    }
    cells += M;
    int64_t cw = 0;
    for (Py_ssize_t i = 0; i < ncw; ++i)
        if (need <= cws[i] - 1) { cw = cws[i]; break; }
    return Py_BuildValue("(LLL)", (long long)cw, (long long)width,
                         (long long)cells);
}

// smooth: monotonize band bounds, then dilate into a radius-R sausage
// (mz_preyama.c:17-35; preyama.smooth). In place on int64 LB/RB (M+1,).
void smooth_c(int64_t* LB, int64_t* RB, Py_ssize_t M, int64_t N,
              int64_t radius) {
    for (Py_ssize_t i = 1; i <= M; ++i)
        if (LB[i] < LB[i - 1]) LB[i] = LB[i - 1];
    for (Py_ssize_t i = 0; i <= M; ++i)
        if (RB[i] > N) RB[i] = N;
    for (Py_ssize_t i = M - 1; i >= 0; --i)
        if (RB[i] > RB[i + 1]) RB[i] = RB[i + 1];
    int64_t radi = radius < (int64_t)M ? radius : (int64_t)M;
    // L2[i] = min(max(LB[i]-radi, 0), LB[i-radi]) for i > radi; else 0.
    // Descending order: reads at i-radi happen before that slot is
    // overwritten (it is only written when the loop reaches it).
    for (Py_ssize_t i = M; i >= radi + 1; --i) {
        int64_t v = LB[i] - radi;
        if (v < 0) v = 0;
        if (LB[i - radi] < v) v = LB[i - radi];
        LB[i] = v;
    }
    for (Py_ssize_t i = 0; i <= radi && i <= M; ++i) LB[i] = 0;
    // R2[i] = max(min(RB[i]+radi, N), RB[i+radi]) for i < M-radi; else N.
    for (Py_ssize_t i = 0; i < M - radi; ++i) {
        int64_t v = RB[i] + radi;
        if (v > N) v = N;
        if (RB[i + radi] > v) v = RB[i + radi];
        RB[i] = v;
    }
    for (Py_ssize_t i = M - radi < 0 ? 0 : M - radi; i <= M; ++i) RB[i] = N;
}

// smooth_into(LB, RB, M, N, radius) — preyama.smooth in place.
PyObject* smooth_into(PyObject*, PyObject* args) {
    PyObject *lbo, *rbo;
    Py_ssize_t M;
    long long N, radius;
    if (!PyArg_ParseTuple(args, "OOnLL", &lbo, &rbo, &M, &N, &radius))
        return nullptr;
    Buf LBb(lbo, PyBUF_WRITABLE), RBb(rbo, PyBUF_WRITABLE);
    if (!LBb.ok || !RBb.ok) return nullptr;
    if (LBb.len() < (Py_ssize_t)((M + 1) * sizeof(int64_t)) ||
        RBb.len() < (Py_ssize_t)((M + 1) * sizeof(int64_t))) {
        PyErr_SetString(PyExc_ValueError, "smooth_into: bad buffers");
        return nullptr;
    }
    smooth_c(reinterpret_cast<int64_t*>(LBb.u8()),
             reinterpret_cast<int64_t*>(RBb.u8()), M, N, radius);
    Py_RETURN_NONE;
}

// ---- pre_yama's DP job (preyama.pre_yama_gen, v == 1) and the fold of
// its result (preyama.maf_build): one pass each over a block's Comps, in
// place of a dozen numpy calls a job and a Python loop over the rows.
// Each answers or raises, as the block cuts do.

PyObject* s_empty;  // () for tp_new

// An int slot of a Comp (any integer); false with an exception set
// where it is unset or not an integer.
bool int_slot(PyObject* o, int i, Py_ssize_t* out) {
    PyObject* v = slots.get(o, i);
    if (!v) {
        PyErr_SetString(PyExc_AttributeError, "a Comp slot is unset");
        return false;
    }
    *out = PyNumber_AsSsize_t(v, PyExc_OverflowError);
    return !(*out == -1 && PyErr_Occurred());
}

// preyama_plan1(comps1, comps2, beg, end, radius)
//   -> (A, B, LB, RB, M, K, N, L, cbeg1, cbeg2, befores) | 0
//   pre_yama's v == 1 job (mz_preyama.c:152-259) in one pass: the four
//   column lookups of beg and end in the top rows (nd_col's rule), A =
//   every row of comps1 over [cbeg1, cend1] as (M, K) columns, B = the
//   rows of comps2 but its first over [cbeg2, cend2] as (N, L) columns
//   with its all-dash columns dropped, and the band from the lockstep walk
//   of the two top rows, monotonized and dilated by radius. A, B: uint8
//   bytearrays; LB, RB: int64 bytearrays of M + 1; befores: int64 bytes,
//   each row's #non-dash before its cut (comps1's, then comps2's but its
//   first), for preyama_fold. 0 where B keeps no column (pre_yama
//   returns None). ValueError where beg or end is not on both top rows.
PyObject* preyama_plan1(PyObject*, PyObject* args) {
    PyObject *c1o, *c2o;
    Py_ssize_t beg, end;
    long long radius;
    if (!PyArg_ParseTuple(args, "OOnnL", &c1o, &c2o, &beg, &end, &radius))
        return nullptr;
    Fast c1(c1o), c2(c2o);
    if (!c1.o || !c2.o) return nullptr;
    Rows R1, R2;
    if (!R1.load_comps(c1.o, 0) || !R2.load_comps(c2.o, 0)) return nullptr;
    if (R1.n < 1 || R2.n < 1) {
        PyErr_SetString(PyExc_ValueError, "preyama_plan1: a block has no rows");
        return nullptr;
    }
    Py_ssize_t st1, sz1, st2, sz2;
    PyObject* top1 = PySequence_Fast_GET_ITEM(c1.o, 0);
    PyObject* top2 = PySequence_Fast_GET_ITEM(c2.o, 0);
    if (!int_slot(top1, slots.START, &st1) || !int_slot(top1, slots.SIZE, &sz1) ||
        !int_slot(top2, slots.START, &st2) || !int_slot(top2, slots.SIZE, &sz2))
        return nullptr;
    const Py_ssize_t W1 = R1.W, W2 = R2.W;
    const Py_ssize_t cb1 = nd_col_of(R1.row(0), W1, beg - st1, sz1);
    const Py_ssize_t ce1 = nd_col_of(R1.row(0), W1, end - st1, sz1);
    const Py_ssize_t cb2 = nd_col_of(R2.row(0), W2, beg - st2, sz2);
    const Py_ssize_t ce2 = nd_col_of(R2.row(0), W2, end - st2, sz2);
    if (cb1 < 0 || ce1 < cb1 || ce1 >= W1 || cb2 < 0 || ce2 < cb2 ||
        ce2 >= W2) {
        PyErr_Format(PyExc_ValueError,
                     "preyama_plan1: %zd-%zd not on both top rows", beg, end);
        return nullptr;
    }
    const Py_ssize_t K = R1.n, L = R2.n - 1;
    const Py_ssize_t M = ce1 - cb1 + 1, N = ce2 - cb2 + 1;
    if (L == 0) return PyLong_FromLong(0);  // every column of B is empty
    // the fold's starts: each template row's #non-dash before its cut
    PyObject* befo = PyBytes_FromStringAndSize(nullptr, (K + L) * 8);
    if (!befo) return nullptr;
    int64_t* bef = reinterpret_cast<int64_t*>(PyBytes_AS_STRING(befo));
    for (Py_ssize_t r = 0; r < K; ++r) bef[r] = R1.before(r, cb1);
    for (Py_ssize_t r = 1; r <= L; ++r) bef[K + r - 1] = R2.before(r, cb2);
    PyObject* ao = PyByteArray_FromStringAndSize(nullptr, M * K);
    PyObject* bo = PyByteArray_FromStringAndSize(nullptr, N * L);
    PyObject* lbo = PyByteArray_FromStringAndSize(nullptr, (M + 1) * 8);
    PyObject* rbo = PyByteArray_FromStringAndSize(nullptr, (M + 1) * 8);
    if (!ao || !bo || !lbo || !rbo) {
        Py_XDECREF(ao); Py_XDECREF(bo); Py_XDECREF(lbo); Py_XDECREF(rbo);
        Py_DECREF(befo);
        return nullptr;
    }
    uint8_t* a = reinterpret_cast<uint8_t*>(PyByteArray_AS_STRING(ao));
    uint8_t* bout = reinterpret_cast<uint8_t*>(PyByteArray_AS_STRING(bo));
    int64_t* LB = reinterpret_cast<int64_t*>(PyByteArray_AS_STRING(lbo));
    int64_t* RB = reinterpret_cast<int64_t*>(PyByteArray_AS_STRING(rbo));
    std::vector<const uint8_t*> brow(L);
    for (Py_ssize_t r = 0; r < L; ++r) brow[r] = R2.row(r + 1) + cb2;
    std::vector<int64_t> map2(N + 1);
    std::vector<Py_ssize_t> nd2(N);
    const uint8_t* t1 = R1.row(0) + cb1;
    const uint8_t* t2 = R2.row(0) + cb2;
    // short call (tens of us): keep the GIL — releasing it queues this
    // thread behind the host-DP lane worker (see sop_score)
    const bool big = (int64_t)N * (L + 1) + (int64_t)M * K > 500000;
    PyThreadState* _save = big ? PyEval_SaveThread() : nullptr;
    for (Py_ssize_t r = 0; r < K; ++r) {
        const uint8_t* p = R1.row(r) + cb1;
        for (Py_ssize_t m = 0; m < M; ++m) a[m * K + r] = p[m];
    }
    // B's columns, all-dash ones dropped; map2[j] = 1-based new col or -1
    Py_ssize_t nn = 0;
    for (Py_ssize_t j = 0; j < N; ++j) {
        uint8_t* q = bout + nn * L;
        bool keep = false;
        for (Py_ssize_t r = 0; r < L; ++r) {
            q[r] = brow[r][j];
            keep |= q[r] != DASH;
        }
        map2[j + 1] = keep ? nn + 1 : -1;
        nn += keep;
    }
    if (nn > 0) {
        // lockstep walk: the t-th non-dash of t1 pairs with the t-th of
        // t2, whose 1-based column is nd2[t]
        Py_ssize_t n2 = 0;
        for (Py_ssize_t j = 0; j < N; ++j) {
            nd2[n2] = j + 1;
            n2 += t2[j] != DASH;
        }
        for (Py_ssize_t i = 0; i <= M; ++i) { LB[i] = 0; RB[i] = nn; }
        for (Py_ssize_t i = 1, t = 0; i <= M && t < n2; ++i) {
            const bool nd = t1[i - 1] != DASH;
            const int64_t c = map2[nd2[t]];
            if (nd && c != -1) { LB[i] = c; RB[i] = c; }
            t += nd;
        }
        smooth_c(LB, RB, M, nn, radius);
    }
    if (_save) PyEval_RestoreThread(_save);
    if (nn == 0 || PyByteArray_Resize(bo, nn * L) != 0) {
        Py_DECREF(ao); Py_DECREF(bo); Py_DECREF(lbo); Py_DECREF(rbo);
        Py_DECREF(befo);
        return nn == 0 ? PyLong_FromLong(0) : nullptr;
    }
    return Py_BuildValue("(NNNNnnnnnnN)", ao, bo, lbo, rbo, M, K, nn, L, cb1,
                         cb2, befo);
}

// preyama_fold(AL, T, comps_a, cbeg_a, comps_b, skip_b, cbeg_b, ss, gop,
//              befores=None) -> (comps, score)
//   maf_build (mz_preyama.c:38-81) in one pass: AL, the DP's merged
//   (ncol, nrow) uint8 columns, transposed into T, a fresh (nrow, ncol)
//   uint8 array; row i's template is comps_a[i], then comps_b[skip_b:],
//   cut at column cbeg_a, cbeg_b. Each row that holds a base becomes a
//   copy of its template (as Comp.copy) with text T[i], start advanced by
//   the template's #non-dash before its cut (befores[i], int64, where
//   given: preyama_plan1's), and size its #non-dash; score is the
//   sop_score of those rows (0 for fewer than two). AL and T must be
//   C-contiguous; ValueError where their shapes, the templates or the
//   cuts do not fit together.
PyObject* preyama_fold(PyObject*, PyObject* args) {
    PyObject *alo, *to, *cao, *cbo, *sso, *gopo, *bfo = Py_None;
    Py_ssize_t cbeg_a, skip_b, cbeg_b;
    if (!PyArg_ParseTuple(args, "OOOnOnnOO|O", &alo, &to, &cao, &cbeg_a, &cbo,
                          &skip_b, &cbeg_b, &sso, &gopo, &bfo))
        return nullptr;
    Buf SS(sso, PyBUF_SIMPLE), GOP(gopo, PyBUF_SIMPLE);
    if (!SS.ok || !GOP.ok) return nullptr;
    if (SS.len() < (Py_ssize_t)(128 * 128 * sizeof(int32_t)) ||
        GOP.len() < (Py_ssize_t)(16 * sizeof(int32_t))) {
        PyErr_SetString(PyExc_ValueError, "preyama_fold: bad tables");
        return nullptr;
    }
    Buf AL(alo, PyBUF_C_CONTIGUOUS), T(to, PyBUF_C_CONTIGUOUS | PyBUF_WRITABLE);
    if (!AL.ok || !T.ok) return nullptr;
    if (AL.view.ndim != 2 || AL.view.itemsize != 1 || T.view.ndim != 2 ||
        T.view.itemsize != 1 || T.view.shape[0] != AL.view.shape[1] ||
        T.view.shape[1] != AL.view.shape[0]) {
        PyErr_SetString(PyExc_ValueError,
                        "preyama_fold: AL and T are not a matrix of bytes "
                        "and its transpose");
        return nullptr;
    }
    const Py_ssize_t ncol = AL.view.shape[0], nrow = AL.view.shape[1];
    Fast ca(cao), cb(cbo);
    if (!ca.o || !cb.o) return nullptr;
    const Py_ssize_t na = PySequence_Fast_GET_SIZE(ca.o);
    if (skip_b < 0 || na + PySequence_Fast_GET_SIZE(cb.o) - skip_b != nrow) {
        PyErr_SetString(PyExc_ValueError,
                        "preyama_fold: the templates are not AL's rows");
        return nullptr;
    }
    const uint8_t* al = AL.u8();
    uint8_t* t = T.u8();
    std::vector<Py_ssize_t> size(nrow, 0);
    for (Py_ssize_t r = 0; r < nrow; ++r) {
        const uint8_t* p = al + r;
        uint8_t* q = t + r * ncol;
        Py_ssize_t n = 0;
        for (Py_ssize_t c = 0; c < ncol; ++c) {
            q[c] = p[c * nrow];
            n += q[c] != DASH;
        }
        size[r] = n;
    }
    // each kept row's #non-dash before its cut: the plan's, else counted
    std::vector<Py_ssize_t> before(nrow, 0);
    if (bfo != Py_None) {
        Buf BF(bfo, PyBUF_SIMPLE);
        if (!BF.ok) return nullptr;
        if (BF.len() != nrow * 8) {
            PyErr_SetString(PyExc_ValueError,
                            "preyama_fold: befores is not an int64 a row");
            return nullptr;
        }
        for (Py_ssize_t r = 0; r < nrow; ++r)
            before[r] = (Py_ssize_t) reinterpret_cast<const int64_t*>(BF.u8())[r];
    } else {
        Rows RA, RB;
        if (!RA.load_comps(ca.o, 0) || !RB.load_comps(cb.o, skip_b))
            return nullptr;
        if (cbeg_a < 0 || cbeg_b < 0 || (RA.n && cbeg_a > RA.W) ||
            (RB.n && cbeg_b > RB.W)) {
            PyErr_SetString(PyExc_ValueError,
                            "preyama_fold: a cut is outside its template");
            return nullptr;
        }
        for (Py_ssize_t r = 0; r < nrow; ++r)
            before[r] = r < na ? RA.before(r, cbeg_a) : RB.before(r - na, cbeg_b);
    }
    std::vector<PyObject*> tmpl(nrow);  // each row's template, checked
    for (Py_ssize_t r = 0; r < nrow; ++r) {
        PyObject* d = tmpl[r] =
            r < na ? PySequence_Fast_GET_ITEM(ca.o, r)
                   : PySequence_Fast_GET_ITEM(cb.o, skip_b + r - na);
        if (size[r] == 0) continue;
        if (!slots.resolve(Py_TYPE(d))) return nullptr;
        for (int s : {slots.START, slots.SRC, slots.STRAND, slots.SRC_SIZE,
                      slots.PARALOG})
            if (!slots.get(d, s)) {  // as Comp.copy
                PyErr_SetString(PyExc_AttributeError, "a Comp slot is unset");
                return nullptr;
            }
    }
    std::vector<const uint8_t*> kept;
    kept.reserve(nrow);
    for (Py_ssize_t r = 0; r < nrow; ++r)
        if (size[r] > 0) kept.push_back(t + r * ncol);
    const Py_ssize_t nk = (Py_ssize_t)kept.size();
    const int64_t score =
        nk >= 2 ? sop_score(kept.data(), nk, 0, ncol, SS.i32(), GOP.i32()) : 0;
    PyObject* comps = PyList_New(nk);
    if (!comps) return nullptr;
    for (Py_ssize_t r = 0, k = 0; r < nrow; ++r) {
        if (size[r] == 0) continue;
        PyObject* d = tmpl[r];
        PyObject* bo = PyLong_FromSsize_t(before[r]);
        PyObject* start = bo ? PyNumber_Add(slots.get(d, slots.START), bo) : nullptr;
        Py_XDECREF(bo);
        PyObject* nc = start ? Py_TYPE(d)->tp_new(Py_TYPE(d), s_empty, nullptr)
                             : nullptr;
        if (!nc) {
            Py_XDECREF(start);
            Py_DECREF(comps);
            return nullptr;
        }
        PyList_SET_ITEM(comps, k++, nc);
        // as Comp.copy(text=...): the coordinate caches start empty
        for (int s : {slots.SRC, slots.STRAND, slots.SRC_SIZE, slots.PARALOG}) {
            PyObject* v = slots.get(d, s);
            Py_XINCREF(v);
            slots.set(nc, s, v);
        }
        slots.set(nc, slots.START, start);
        slots.set(nc, slots.SIZE, PyLong_FromSsize_t(size[r]));
        slots.set(nc, slots.TEXT, PySequence_GetItem(to, r));  // T[r], a view
        Py_INCREF(Py_None);
        slots.set(nc, slots.PM, Py_None);
        Py_INCREF(Py_None);
        slots.set(nc, slots.ND, Py_None);
        if (!slots.get(nc, slots.SIZE) || !slots.get(nc, slots.TEXT)) {
            Py_DECREF(comps);
            return nullptr;
        }
    }
    return Py_BuildValue("(Nd)", comps, (double)score);
}

// Core of the host DP: validation happens in the wrappers (so errors
// can raise with the GIL held); this body is pure C and runs with the
// GIL released. Returns nedit, or -1 on an internal traceback error.
Py_ssize_t yama_run(const uint8_t* a, Py_ssize_t M, Py_ssize_t K,
                    const uint8_t* b, Py_ssize_t N, Py_ssize_t L,
                    const int64_t* LB, const int64_t* RB,
                    const int32_t* ss, const int8_t* c8,
                    long go, long ge, int64_t tb_cells, uint8_t* outbuf) {
    constexpr int64_t MININT = -(int64_t(1) << 30);

    // ---- per-column stats (yama.py column_stats) ----
    auto stats = [&](const uint8_t* x, Py_ssize_t ncol, Py_ssize_t nrow,
                     int32_t* hist, int64_t* n0, int64_t* n1, int64_t* pr) {
        for (Py_ssize_t i = 1; i <= ncol; ++i) {
            const uint8_t* col = x + (i - 1) * nrow;
            int32_t hc[6] = {0, 0, 0, 0, 0, 0};
            int64_t dash = 0;
            for (Py_ssize_t r = 0; r < nrow; ++r) {
                hc[c8[col[r]]] += 1;
                dash += (col[r] == DASH);
            }
            for (int k = 0; k < 6; ++k) hist[i * 6 + k] = hc[k];
            n1[i] = dash;
            n0[i] = (int64_t)nrow - dash;
            if (i == 1) {
                pr[4 + 0] = n0[1];
                pr[4 + 1] = n1[1];
                pr[4 + 2] = 0;
                pr[4 + 3] = 0;
            } else {
                const uint8_t* prev = col - nrow;
                int64_t p[4] = {0, 0, 0, 0};
                for (Py_ssize_t r = 0; r < nrow; ++r)
                    p[((prev[r] == DASH) << 1) | (col[r] == DASH)] += 1;
                for (int k = 0; k < 4; ++k) pr[i * 4 + k] = p[k];
            }
        }
    };
    int32_t* histA = new int32_t[(M + 1) * 6]();
    int32_t* histB = new int32_t[(N + 1) * 6]();
    int64_t* a0 = new int64_t[M + 1]();
    int64_t* a1 = new int64_t[M + 1]();
    int64_t* pa = new int64_t[(M + 1) * 4]();
    int64_t* b0 = new int64_t[N + 1]();
    int64_t* b1 = new int64_t[N + 1]();
    int64_t* pb = new int64_t[(N + 1) * 4]();
    stats(a, M, K, histA, a0, a1, pa);
    stats(b, N, L, histB, b0, b1, pb);
    // substitution projection: sr[col][c] = sum_c' ss[c][c'] * histB[col][c']
    int64_t* sr = new int64_t[(N + 1) * 6]();
    for (Py_ssize_t j = 1; j <= N; ++j)
        for (int c = 0; c < 6; ++c) {
            int64_t s = 0;
            for (int d = 0; d < 6; ++d)
                s += (int64_t)ss[c * 6 + d] * histB[j * 6 + d];
            sr[j * 6 + c] = s;
        }

    int64_t* dpC = new int64_t[N + 1];
    int64_t* dpD = new int64_t[N + 1];
    int64_t* dpI = new int64_t[N + 1];
    // Row-indexed band traceback: trow[r] + col addresses the flag of
    // in-band cell (r, col) (the reference's tback_row[row] = tbp - LB[row],
    // mz_yama.c:77-91).
    uint8_t* flags = new uint8_t[tb_cells]();
    uint8_t** trow = new uint8_t*[M + 1];
    {
        uint8_t* tbp = flags;
        for (Py_ssize_t r = 0; r <= M; ++r) {
            trow[r] = tbp - LB[r];
            tbp += RB[r] - LB[r] + 1;
        }
    }
    for (Py_ssize_t j = 0; j <= N; ++j) dpC[j] = dpD[j] = dpI[j] = MININT;
    dpC[0] = dpD[0] = dpI[0] = 0;
    {
        int64_t acc = 0;
        for (Py_ssize_t j = 1; j <= RB[0]; ++j) {
            acc += b0[j];
            dpI[j] = -acc * (int64_t)K * ge;
            trow[0][j] = FLAG_I << 4;
        }
    }
    int64_t lastC = MININT, lastD = MININT, lastI = MININT;

    for (Py_ssize_t row = 1; row <= M; ++row) {
        const int64_t lb = LB[row], rb = RB[row];
        const int64_t lbm1 = LB[row - 1];
        const int64_t lbm2 = row > 1 ? LB[row - 2] : 0;
        const int64_t pa0 = pa[row * 4 + 0], pa1 = pa[row * 4 + 1],
                      pa2 = pa[row * 4 + 2], pa3 = pa[row * 4 + 3];
        const int64_t a0r = a0[row], a1r = a1[row];
        const int32_t* hA = histA + row * 6;
        uint8_t* frow = trow[row];
        int64_t diagC, diagD, diagI;  // previous row's value at col-1
        if (lb >= 1) {
            diagC = dpC[lb - 1];
            diagD = dpD[lb - 1];
            diagI = dpI[lb - 1];
            if (lbm1 > lb - 1) diagC = diagD = diagI = MININT;
        } else {
            diagC = diagD = diagI = MININT;
        }
        int64_t prevC = MININT, prevD = MININT, Iprev = MININT;
        const bool live = row < M;
        for (int64_t c = lb; c <= rb; ++c) {
            const int64_t upC = dpC[c], upD = dpD[c], upI = dpI[c];
            const bool inner = c > 0 && c < N;
            // ---- D node ----
            int64_t xs = upC, ys = upD, zs = upI;
            if (row > 1 && inner) {
                if (c > lbm2) xs -= go * (pa0 * b0[c] + pa2 * (int64_t)L);
                ys -= go * pa2 * (int64_t)L;
            }
            if (inner && c > lbm1) zs -= go * a0r * (int64_t)L;
            uint8_t fd;
            int64_t Dv;
            if (xs >= ys && xs >= zs) { Dv = xs; fd = FLAG_C; }
            else if (ys > zs) { Dv = ys; fd = FLAG_D; }
            else { Dv = zs; fd = FLAG_I; }
            Dv -= a0r * (int64_t)L * ge;
            // ---- C node ----
            const int64_t pb0c = pb[c * 4 + 0], pb1c = pb[c * 4 + 1],
                          pb2c = pb[c * 4 + 2], pb3c = pb[c * 4 + 3];
            xs = diagC; ys = diagD; zs = diagI;
            const bool gt1 = c > 1;
            if (row > 1 && gt1) {
                if (c > lbm2 + 1)
                    xs -= go * (pa0 * pb1c + pa1 * (pb0c + pb2c)
                                + pa2 * (pb1c + pb3c) + pa3 * pb2c);
                ys -= go * (pa1 * b0[c] + pa2 * b1[c] + pa3 * b0[c]);
            }
            if (gt1 && c > lbm1 + 1)
                zs -= go * (a0r * (pb1c + pb3c) + a1r * pb2c);
            uint8_t fc = 0;
            int64_t Cv = MININT;
            if (c > lbm1) {
                int64_t sub = 0;
                const int64_t* src = sr + c * 6;
                for (int d = 0; d < 6; ++d) sub += hA[d] * src[d];
                if (xs >= ys && xs >= zs) { Cv = xs; fc = FLAG_C; }
                else if (ys > zs) { Cv = ys; fc = FLAG_D; }
                else { Cv = zs; fc = FLAG_I; }
                Cv += sub;
            }
            // ---- I node ----
            uint8_t fi = 0;
            int64_t Iv = MININT;
            if (c > lb) {
                int64_t xI = 0, yI = 0, zI = 0;
                if (live) {
                    xI = go * (a0r * (pb0c + pb2c) + a1r * pb2c);
                    yI = go * (int64_t)K * b0[c];
                    zI = go * (int64_t)K * pb2c;
                }
                int64_t x = prevC - (c > lbm1 + 1 ? xI : 0);
                int64_t y = prevD - yI;
                int64_t z = Iprev - (c > lb + 1 ? zI : 0);
                if (x >= y && x >= z) { Iv = x; fi = FLAG_C; }
                else if (y > z) { Iv = y; fi = FLAG_D; }
                else { Iv = z; fi = FLAG_I; }
                Iv -= b0[c] * (int64_t)K * ge;
                Iprev = Iv;
            } else {
                Iprev = MININT;
            }
            frow[c] = fc | (fd << 2) | (fi << 4);
            // roll the diagonal and store
            diagC = dpC[c]; diagD = dpD[c]; diagI = dpI[c];
            dpC[c] = Cv; dpD[c] = Dv; dpI[c] = Iv;
            prevC = Cv; prevD = Dv;
        }
        lastC = dpC[rb]; lastD = dpD[rb]; lastI = dpI[rb];
    }
    if (M == 0) lastC = lastD = lastI = MININT;

    // ---- traceback (newest-first) + replay into out ----
    uint8_t* script = new uint8_t[M + N];
    uint8_t node;
    if (lastC >= lastD && lastC >= lastI) node = FLAG_C;
    else if (lastD >= lastI) node = FLAG_D;
    else node = FLAG_I;
    Py_ssize_t row = M, col = N, nedit = 0;
    bool bad = false;
    while (row > 0 || col > 0) {
        if (row < 0 || col < 0 || nedit >= M + N ||
            col < LB[row] || col > RB[row]) { bad = true; break; }
        uint8_t st = trow[row][col];
        script[nedit++] = node;
        if (node == FLAG_I) { col -= 1; node = st >> 4; }
        else if (node == FLAG_D) { row -= 1; node = (st >> 2) & SELECT_CID; }
        else if (node == FLAG_C) { row -= 1; col -= 1; node = st & SELECT_CID; }
        else { bad = true; break; }
    }
    Py_ssize_t result = -1;
    if (!bad) {
        uint8_t* out = outbuf;
        const Py_ssize_t W = K + L;
        Py_ssize_t ai = 0, bi = 0;
        for (Py_ssize_t t = 0; t < nedit && !bad; ++t) {
            uint8_t op = script[nedit - 1 - t];
            uint8_t* r = out + t * W;
            if (op != FLAG_I) {
                if (ai >= M) { bad = true; break; }
                std::memcpy(r, a + ai * K, K);
                ++ai;
            } else {
                std::memset(r, DASH, K);
            }
            if (op != FLAG_D) {
                if (bi >= N) { bad = true; break; }
                std::memcpy(r + K, b + bi * L, L);
                ++bi;
            } else {
                std::memset(r + K, DASH, L);
            }
        }
        if (!bad && (ai != M || bi != N)) bad = true;
        if (!bad) result = nedit;
    }
    delete[] histA; delete[] histB; delete[] a0; delete[] a1; delete[] pa;
    delete[] b0; delete[] b1; delete[] pb; delete[] sr;
    delete[] dpC; delete[] dpD; delete[] dpI; delete[] flags; delete[] trow;
    delete[] script;
    return result;
}

// Validate one problem's band with the GIL held; returns tb_cells or -1
// with a Python error set.
int64_t yama_validate(Py_ssize_t M, Py_ssize_t N, const int64_t* LB,
                      const int64_t* RB) {
    // Traceback storage is band-sized, exactly like the reference's
    // tback_size = sum over rows of RB-LB+1 (mz_yama.c:60-77): a 50kb x
    // 50kb R=30 problem needs ~3MB, not (M+1)*(N+1) = 2.5GB.
    // Full entry sanity checks of yama (mz_yama.c:58-71), so the Python
    // caller can skip its own pass when dispatching here.
    if (LB[0] != 0 || RB[M] != N) {
        PyErr_SetString(PyExc_ValueError,
                        "LB and RB not terminated properly");
        return -1;
    }
    const int64_t minw = N < 10 ? N : 10;
    int64_t tb_cells = 0;
    for (Py_ssize_t r = 0; r <= M; ++r) {
        if (RB[r] < LB[r] || LB[r] < 0 || RB[r] > N ||
            RB[r] - LB[r] < minw) {
            PyErr_SetString(PyExc_ValueError, "yama_into: bad band");
            return -1;
        }
        if (r > 0 && (LB[r] < LB[r - 1] || RB[r] < RB[r - 1])) {
            PyErr_SetString(PyExc_ValueError,
                            "yama_into: band not monotonic");
            return -1;
        }
        tb_cells += RB[r] - LB[r] + 1;
    }
    if (tb_cells > (int64_t)1 << 36) {  // 64 GiB of flags: hopeless
        PyErr_SetString(PyExc_ValueError, "yama_into: problem too large");
        return -1;
    }
    return tb_cells;
}

// yama_into(A, M, K, B, N, L, LB, RB, ss_cat, cat, go, ge, out) -> nedit
//   Full banded DP + traceback + replay on host: the same integer
//   recurrence as multiz_tpu/yama.py yama_numpy (per-column statistics
//   collapse the reference's K*L inner loops, mz_yama.c:123-225, into
//   a handful of products), with identical C>=D>I tie-breaking.
//   A: uint8 (M, K); B: uint8 (N, L); LB/RB: int64 (M+1,);
//   ss_cat: int32 (6, 6); cat: int8[256]; out: uint8 (M+N, K+L).
PyObject* yama_into(PyObject*, PyObject* args) {
    PyObject *ao, *bo, *lbo, *rbo, *sso, *cato, *oo;
    Py_ssize_t M, K, N, L;
    long go, ge;
    if (!PyArg_ParseTuple(args, "OnnOnnOOOOllO", &ao, &M, &K, &bo, &N, &L,
                          &lbo, &rbo, &sso, &cato, &go, &ge, &oo))
        return nullptr;
    Buf A(ao, PyBUF_SIMPLE), B(bo, PyBUF_SIMPLE), LBb(lbo, PyBUF_SIMPLE),
        RBb(rbo, PyBUF_SIMPLE), SS(sso, PyBUF_SIMPLE), CAT(cato, PyBUF_SIMPLE),
        O(oo, PyBUF_WRITABLE);
    if (!A.ok || !B.ok || !LBb.ok || !RBb.ok || !SS.ok || !CAT.ok || !O.ok)
        return nullptr;
    if (A.len() < M * K || B.len() < N * L ||
        LBb.len() < (Py_ssize_t)((M + 1) * sizeof(int64_t)) ||
        RBb.len() < (Py_ssize_t)((M + 1) * sizeof(int64_t)) ||
        SS.len() < (Py_ssize_t)(36 * sizeof(int32_t)) || CAT.len() < 256 ||
        O.len() < (M + N) * (K + L)) {
        PyErr_SetString(PyExc_ValueError, "yama_into: bad buffer sizes");
        return nullptr;
    }
    const int64_t* LB = reinterpret_cast<const int64_t*>(LBb.u8());
    const int64_t* RB = reinterpret_cast<const int64_t*>(RBb.u8());
    int64_t tb_cells = yama_validate(M, N, LB, RB);
    if (tb_cells < 0) return nullptr;
    Py_ssize_t result;
    {
        PyThreadState* _save = PyEval_SaveThread();  // pure C below
        result = yama_run(
            A.u8(), M, K, B.u8(), N, L, LB, RB, SS.i32(),
            reinterpret_cast<const int8_t*>(CAT.u8()), go, ge, tb_cells,
            O.u8());
        PyEval_RestoreThread(_save);
    }
    if (result < 0) {
        PyErr_SetString(PyExc_ValueError,
                        "yama_into: error generating edit script");
        return nullptr;
    }
    return PyLong_FromSsize_t(result);
}

// yama_many(problems, ss_cat, cat, go, ge) -> list[nedit]
//   problems: sequence of (A, M, K, B, N, L, LB, RB, out) tuples.
//   Runs every DP under ONE GIL release — the host DP lane's worker
//   thread uses this so it re-acquires the GIL once per chunk instead
//   of once per job (per-job handoffs convoy against the planning
//   thread's 5 ms GIL slices).
PyObject* yama_many(PyObject*, PyObject* args) {
    PyObject* seq;
    PyObject *sso, *cato;
    long go, ge;
    if (!PyArg_ParseTuple(args, "OOOll", &seq, &sso, &cato, &go, &ge))
        return nullptr;
    Buf SS(sso, PyBUF_SIMPLE), CAT(cato, PyBUF_SIMPLE);
    if (!SS.ok || !CAT.ok) return nullptr;
    if (SS.len() < (Py_ssize_t)(36 * sizeof(int32_t)) || CAT.len() < 256) {
        PyErr_SetString(PyExc_ValueError, "yama_many: bad tables");
        return nullptr;
    }
    PyObject* fast = PySequence_Fast(seq, "yama_many: expected a sequence");
    if (!fast) return nullptr;
    const Py_ssize_t n = PySequence_Fast_GET_SIZE(fast);
    struct Job {
        Buf A, B, LBb, RBb, O;
        Py_ssize_t M, K, N, L;
        int64_t tb_cells;
        Py_ssize_t nedit;
        Job(PyObject* a, PyObject* b, PyObject* lb, PyObject* rb,
            PyObject* o)
            : A(a, PyBUF_SIMPLE), B(b, PyBUF_SIMPLE),
              LBb(lb, PyBUF_SIMPLE), RBb(rb, PyBUF_SIMPLE),
              O(o, PyBUF_WRITABLE) {}
    };
    std::vector<Job*> jobs;
    jobs.reserve(n);
    bool ok = true;
    for (Py_ssize_t i = 0; i < n && ok; ++i) {
        PyObject* t = PySequence_Fast_GET_ITEM(fast, i);
        PyObject *ao, *bo, *lbo, *rbo, *oo;
        Py_ssize_t M, K, N, L;
        if (!PyArg_ParseTuple(t, "OnnOnnOOO", &ao, &M, &K, &bo, &N, &L,
                              &lbo, &rbo, &oo)) {
            ok = false;
            break;
        }
        Job* j = new Job(ao, bo, lbo, rbo, oo);
        j->M = M; j->K = K; j->N = N; j->L = L;
        jobs.push_back(j);
        if (!j->A.ok || !j->B.ok || !j->LBb.ok || !j->RBb.ok || !j->O.ok) {
            ok = false;
            break;
        }
        if (j->A.len() < M * K || j->B.len() < N * L ||
            j->LBb.len() < (Py_ssize_t)((M + 1) * sizeof(int64_t)) ||
            j->RBb.len() < (Py_ssize_t)((M + 1) * sizeof(int64_t)) ||
            j->O.len() < (M + N) * (K + L)) {
            PyErr_SetString(PyExc_ValueError, "yama_many: bad buffers");
            ok = false;
            break;
        }
        j->tb_cells = yama_validate(
            M, N, reinterpret_cast<const int64_t*>(j->LBb.u8()),
            reinterpret_cast<const int64_t*>(j->RBb.u8()));
        if (j->tb_cells < 0) ok = false;
    }
    Py_ssize_t bad_at = -1;
    if (ok) {
        const int32_t* ss = SS.i32();
        const int8_t* c8 = reinterpret_cast<const int8_t*>(CAT.u8());
        PyThreadState* _save = PyEval_SaveThread();
        for (Py_ssize_t i = 0; i < (Py_ssize_t)jobs.size(); ++i) {
            Job* j = jobs[i];
            j->nedit = yama_run(
                j->A.u8(), j->M, j->K, j->B.u8(), j->N, j->L,
                reinterpret_cast<const int64_t*>(j->LBb.u8()),
                reinterpret_cast<const int64_t*>(j->RBb.u8()),
                ss, c8, go, ge, j->tb_cells, j->O.u8());
            if (j->nedit < 0) { bad_at = i; break; }
        }
        PyEval_RestoreThread(_save);
    }
    PyObject* out = nullptr;
    if (ok && bad_at < 0) {
        out = PyList_New(jobs.size());
        if (out)
            for (Py_ssize_t i = 0; i < (Py_ssize_t)jobs.size(); ++i)
                PyList_SET_ITEM(out, i, PyLong_FromSsize_t(jobs[i]->nedit));
    } else if (ok) {
        PyErr_Format(PyExc_ValueError,
                     "yama_many: error generating edit script (job %zd)",
                     bad_at);
    }
    for (Job* j : jobs) delete j;
    Py_DECREF(fast);
    return out;
}

// ---- the DP stream's per-launch host stages (yama_pack.pack_wire and
// _replay_payload_slots): one pass over a launch's jobs each, in place of
// a numpy loop a job. A job's arrays are read in place where they are
// C-contiguous, else gathered through their strides.

// One side's category nibbles (prep.wire_layout): X (ncol, nrow) bytes ->
// dst (rp2, pad); packed row p holds row p in its low nibble and row
// p + rp2 in its high one (the device unpack is a plain concat,
// prep.col_stats). Every byte of dst is written.
void pack_cats(uint8_t* dst, const uint8_t* X, Py_ssize_t ncol,
               Py_ssize_t nrow, Py_ssize_t rp2, Py_ssize_t pad,
               const uint8_t* cat) {
    for (Py_ssize_t r = 0; r < rp2; ++r) {
        uint8_t* d = dst + r * pad;
        if (r >= nrow) {
            std::memset(d, 0, pad);
            continue;
        }
        const uint8_t* x = X + r;
        if (r + rp2 < nrow) {
            const Py_ssize_t h = rp2;
            for (Py_ssize_t c = 0; c < ncol; ++c)
                d[c] = cat[x[c * nrow]] | (uint8_t)(cat[x[c * nrow + h]] << 4);
        } else {
            for (Py_ssize_t c = 0; c < ncol; ++c) d[c] = cat[x[c * nrow]];
        }
        std::memset(d + ncol, 0, pad - ncol);
    }
}

// A band bound's int32 wire row: rows 0..M, then row M out to mp1.
inline void pack_band(int32_t* d, const int64_t* s, Py_ssize_t M,
                      Py_ssize_t mp1) {
    for (Py_ssize_t r = 0; r <= M; ++r) d[r] = (int32_t)s[r];
    std::fill(d + M + 1, d + mp1, d[M]);
}

// A launch's pass runs with the GIL released where it is long (1 MiB of
// wire or of results: about a millisecond), so that the host lane's
// workers are not held for the whole pass; a short one keeps it
// (releasing it queues the calling thread behind the lane's workers, see
// sop_score).
constexpr int64_t STREAM_NOGIL_BYTES = 1 << 20;

// pack_wire_into(jobs, buf, m_pad, n_pad, Kp, Lp, (A, B, LB, RB, MNKL,
//                end), cat)
//   One bucket's wire buffer (prep.wire_layout's offsets, given) from
//   (A, B, LB, RB) jobs: A (M, K) and B (N, L) bytes as category nibbles
//   (cat: int8[256]), LB and RB (int64, >= M + 1) as int32 rows
//   0..M then row M out to m_pad, and (M, N, K, L). Every byte of buf up
//   to end is written (padding 0). ValueError where a job does not fit
//   the bucket.
PyObject* pack_wire_into(PyObject*, PyObject* args) {
    PyObject *jo, *bo, *cato;
    Py_ssize_t m_pad, n_pad, Kp, Lp, oA, oB, oLB, oRB, oM, end;
    if (!PyArg_ParseTuple(args, "OOnnnn(nnnnnn)O", &jo, &bo, &m_pad, &n_pad,
                          &Kp, &Lp, &oA, &oB, &oLB, &oRB, &oM, &end, &cato))
        return nullptr;
    Fast jobs(jo);
    if (!jobs.o) return nullptr;
    Buf out(bo, PyBUF_WRITABLE), cat(cato, PyBUF_SIMPLE);
    if (!out.ok || !cat.ok) return nullptr;
    const Py_ssize_t nb = PySequence_Fast_GET_SIZE(jobs.o);
    const Py_ssize_t Kp2 = (Kp + 1) / 2, Lp2 = (Lp + 1) / 2, mp1 = m_pad + 1;
    const Py_ssize_t a_end = oA + nb * Kp2 * m_pad;
    const Py_ssize_t b_end = oB + nb * Lp2 * n_pad;
    const Py_ssize_t rows = nb * mp1 * 4;
    uint8_t* w = out.u8();
    if (cat.len() < 256 || m_pad < 0 || n_pad < 0 || Kp < 0 || Lp < 0 ||
        oA < 0 || a_end > oB || b_end > oLB || oLB + rows > oRB ||
        oRB + rows > oM || oM + nb * 16 > end || end > out.len() ||
        ((uintptr_t)(w + oLB) | (uintptr_t)(w + oRB) | (uintptr_t)(w + oM)) % 4) {
        PyErr_SetString(PyExc_ValueError, "pack_wire_into: bad layout");
        return nullptr;
    }
    // every job's arrays first, with the GIL
    struct Job {
        Mat A, B;
        Ints LB, RB;
    };
    std::unique_ptr<Job[]> jv(new Job[nb]);
    for (Py_ssize_t i = 0; i < nb; ++i) {
        Fast job(PySequence_Fast_GET_ITEM(jobs.o, i));
        if (!job.o) return nullptr;
        if (PySequence_Fast_GET_SIZE(job.o) != 4) {
            PyErr_SetString(PyExc_ValueError, "a job is not (A, B, LB, RB)");
            return nullptr;
        }
        Job& J = jv[i];
        PyObject** it = PySequence_Fast_ITEMS(job.o);
        if (!J.A.load(it[0], "A") || !J.B.load(it[1], "B") ||
            !J.LB.load(it[2], "LB") || !J.RB.load(it[3], "RB"))
            return nullptr;
        const Py_ssize_t M = J.A.rows, K = J.A.cols, N = J.B.rows,
                         L = J.B.cols;
        if (M > m_pad || N > n_pad || K > 2 * Kp2 || L > 2 * Lp2 ||
            J.LB.n < M + 1 || J.RB.n < M + 1) {
            PyErr_Format(PyExc_ValueError,
                         "job %zd (M %zd, N %zd, K %zd, L %zd, band %zd) "
                         "does not fit the bucket (%zd, %zd, %zd, %zd)",
                         i, M, N, K, L, std::min(J.LB.n, J.RB.n), m_pad,
                         n_pad, Kp, Lp);
            return nullptr;
        }
    }
    const uint8_t* ct = cat.u8();
    PyThreadState* _save =
        end >= STREAM_NOGIL_BYTES ? PyEval_SaveThread() : nullptr;
    // the gaps between the regions
    std::memset(w, 0, oA);
    std::memset(w + a_end, 0, oB - a_end);
    std::memset(w + b_end, 0, oLB - b_end);
    std::memset(w + oLB + rows, 0, oRB - oLB - rows);
    std::memset(w + oRB + rows, 0, oM - oRB - rows);
    std::memset(w + oM + nb * 16, 0, end - oM - nb * 16);
    int32_t* lbs = reinterpret_cast<int32_t*>(w + oLB);
    int32_t* rbs = reinterpret_cast<int32_t*>(w + oRB);
    int32_t* mnkl = reinterpret_cast<int32_t*>(w + oM);
    for (Py_ssize_t i = 0; i < nb; ++i) {
        const Job& J = jv[i];
        const Py_ssize_t M = J.A.rows, N = J.B.rows;
        pack_cats(w + oA + i * Kp2 * m_pad, J.A.p, M, J.A.cols, Kp2, m_pad,
                  ct);
        pack_cats(w + oB + i * Lp2 * n_pad, J.B.p, N, J.B.cols, Lp2, n_pad,
                  ct);
        pack_band(lbs + i * mp1, J.LB.p, M, mp1);
        pack_band(rbs + i * mp1, J.RB.p, M, mp1);
        int32_t* q = mnkl + 4 * i;
        q[0] = (int32_t)M;
        q[1] = (int32_t)N;
        q[2] = (int32_t)J.A.cols;
        q[3] = (int32_t)J.B.cols;
    }
    if (_save) PyEval_RestoreThread(_save);
    Py_RETURN_NONE;
}

// A new writable (n, w) uint8 numpy array (numpy.empty and the dtype
// looked up once); nullptr with the error set.
PyObject* new_u8_matrix(Py_ssize_t n, Py_ssize_t w) {
    static PyObject *empty = nullptr, *u8 = nullptr;
    if (!empty) {
        PyObject* np = PyImport_ImportModule("numpy");
        if (!np) return nullptr;
        PyObject* e = PyObject_GetAttrString(np, "empty");
        PyObject* d = e ? PyObject_CallMethod(np, "dtype", "s", "uint8")
                        : nullptr;
        Py_DECREF(np);
        if (!d) {
            Py_XDECREF(e);
            return nullptr;
        }
        empty = e;
        u8 = d;
    }
    return PyObject_CallFunction(empty, "(nn)O", n, w, u8);
}

// replay_payload(payload, slots, jobs, results)
//   One launch's payload (yama_tb): row i holds the [nedit LE32] and the
//   2-bit ops, newest first, 4 a byte, low bits first, of the job
//   jobs[slots[i]] (an (A, B, ...) sequence; jobs a mapping); its merged
//   (nedit, K + L) uint8 matrix is stored at results[slots[i]] (a mapping
//   or a list) and the job popped from jobs. ValueError at the first job,
//   in order, whose nedit overruns its row or whose script does not
//   consume A and B exactly: the jobs before it keep their results, and
//   it and they are popped.
PyObject* replay_payload(PyObject*, PyObject* args) {
    PyObject *po, *so, *jobs, *results;
    if (!PyArg_ParseTuple(args, "OOOO", &po, &so, &jobs, &results))
        return nullptr;
    Fast slots(so);
    if (!slots.o) return nullptr;
    Mat P;
    if (!P.load(po, "the payload")) return nullptr;
    const Py_ssize_t nb = PySequence_Fast_GET_SIZE(slots.o), pw = P.cols;
    if (P.rows < nb || pw < 4) {
        PyErr_Format(PyExc_ValueError,
                     "a payload of %zd rows of %zd bytes for %zd jobs",
                     P.rows, pw, nb);
        return nullptr;
    }
    // with the GIL: every job's A and B and an empty result, up to the
    // first job that fails (bad; its error saved) ...
    struct Job {
        Mat A, B;
        Py_ssize_t ne = 0;
        PyObject* m = nullptr;  // the result, owned
        uint8_t* o = nullptr;   // its bytes
        ~Job() { Py_XDECREF(m); }
    };
    std::unique_ptr<Job[]> jv(new Job[nb]);
    Py_ssize_t bad = nb, got = 0;
    int64_t work = 0;
    for (Py_ssize_t i = 0; i < nb && bad == nb; ++i) {
        Job& J = jv[i];
        bad = i;  // until job i is ready
        PyObject* jo =
            PyObject_GetItem(jobs, PySequence_Fast_GET_ITEM(slots.o, i));
        if (!jo) break;
        got = i + 1;
        Fast job(jo);
        Py_DECREF(jo);  // held by job.o
        if (!job.o) break;
        if (PySequence_Fast_GET_SIZE(job.o) < 2) {
            PyErr_SetString(PyExc_ValueError, "a job has no A and B");
            break;
        }
        if (!J.A.load(PySequence_Fast_GET_ITEM(job.o, 0), "A") ||
            !J.B.load(PySequence_Fast_GET_ITEM(job.o, 1), "B"))
            break;
        const uint8_t* row = P.p + i * pw;
        const uint32_t ne = (uint32_t)row[0] | (uint32_t)row[1] << 8 |
                            (uint32_t)row[2] << 16 | (uint32_t)row[3] << 24;
        if (4 + ((Py_ssize_t)ne + 3) / 4 > pw) {
            PyErr_Format(PyExc_ValueError,
                         "payload row %zd: nedit %lu overruns its %zd bytes",
                         i, (unsigned long)ne, pw);
            break;
        }
        const Py_ssize_t W = J.A.cols + J.B.cols;
        J.ne = ne;
        J.m = new_u8_matrix(J.ne, W);
        if (!J.m) break;
        Buf O(J.m, PyBUF_WRITABLE);
        if (!O.ok) break;
        if (O.len() != J.ne * W) {
            PyErr_SetString(PyExc_ValueError,
                            "replay_payload: a result of the wrong size");
            break;
        }
        J.o = O.u8();  // J.m keeps the array, and so its bytes
        work += J.ne * W;
        bad = nb;
    }
    PyObject *et = nullptr, *ev = nullptr, *etb = nullptr;
    if (bad < nb) PyErr_Fetch(&et, &ev, &etb);
    // ... then the rows of jobs [0, bad), up to the first script that
    // does not consume A and B exactly (fault) ...
    Py_ssize_t fault = bad;
    PyThreadState* _save =
        work >= STREAM_NOGIL_BYTES ? PyEval_SaveThread() : nullptr;
    for (Py_ssize_t i = 0; i < bad; ++i) {
        const Job& J = jv[i];
        const uint8_t* pk = P.p + i * pw + 4;
        const Py_ssize_t n = J.ne;
        auto op = [pk, n](Py_ssize_t t) {
            const Py_ssize_t j = n - 1 - t;
            return (uint8_t)((pk[j >> 2] >> ((j & 3) * 2)) & 3);
        };
        if (!replay_rows(op, n, J.A.p, J.A.rows, J.A.cols, J.B.p, J.B.rows,
                         J.B.cols, J.o)) {
            fault = i;
            break;
        }
    }
    if (_save) PyEval_RestoreThread(_save);
    if (fault < bad) {  // an earlier job than the saved error's
        Py_XDECREF(et);
        Py_XDECREF(ev);
        Py_XDECREF(etb);
        et = ev = etb = nullptr;
    }
    // ... and, with the GIL, the results of jobs [0, fault) stored and
    // jobs [0, fault] popped
    const Py_ssize_t pop = std::min(fault < nb ? fault + 1 : nb, got);
    for (Py_ssize_t i = 0; i < pop; ++i) {
        PyObject* slot = PySequence_Fast_GET_ITEM(slots.o, i);
        if ((i < fault && PyObject_SetItem(results, slot, jv[i].m) != 0) ||
            PyObject_DelItem(jobs, slot) != 0) {
            Py_XDECREF(et);
            Py_XDECREF(ev);
            Py_XDECREF(etb);
            return nullptr;
        }
    }
    if (et) {
        PyErr_Restore(et, ev, etb);
        return nullptr;
    }
    if (fault < nb) {
        PyErr_Format(PyExc_ValueError, "payload row %zd: %s", fault,
                     NOT_EXACT);
        return nullptr;
    }
    Py_RETURN_NONE;
}

PyMethodDef methods[] = {
    {"colstats_into", colstats_into, METH_VARARGS,
     "per-column stats into pre-allocated int32 buffers"},
    {"yama_into", yama_into, METH_VARARGS,
     "full banded DP + traceback + replay; returns nedit"},
    {"yama_many", yama_many, METH_VARARGS,
     "batched host DP: many problems under one GIL release"},
    {"score_range", score_range, METH_VARARGS,
     "sum-of-pairs mafScoreRange over stacked text rows"},
    {"keep_cut", keep_cut, METH_VARARGS,
     "keep_ali's cut column and each row's count before it"},
    {"part_cut", part_cut, METH_VARARGS,
     "make_part_ali_col's counts, dash-column mask and score"},
    {"nd_col", nd_col, METH_VARARGS,
     "column of a row's k-th non-dash char, scanned from its nearer end"},
    {"nondash_count", nondash_count, METH_VARARGS,
     "#non-dash chars before a column of a row"},
    {"band_info", band_info, METH_VARARGS,
     "band validation + window ladder pick + cell count in one pass"},
    {"smooth_into", smooth_into, METH_VARARGS,
     "monotonize + radius-dilate band bounds in place (preyama.smooth)"},
    {"preyama_plan1", preyama_plan1, METH_VARARGS,
     "pre_yama's v==1 job: column lookups, A, compacted B, band"},
    {"preyama_fold", preyama_fold, METH_VARARGS,
     "maf_build: merged columns -> kept rows' Comps and their score"},
    {"traceback_into", traceback_into, METH_VARARGS,
     "edit-script extraction (newest-first); returns nedit"},
    {"replay_into", replay_into, METH_VARARGS,
     "edit script -> merged column matrix"},
    {"pack_wire_into", pack_wire_into, METH_VARARGS,
     "one bucket's wire buffer from its jobs"},
    {"replay_payload", replay_payload, METH_VARARGS,
     "one launch's payload -> merged column matrices"},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_mzcore",
    "native host runtime for multiz_tpu", -1, methods,
};

}  // namespace

PyMODINIT_FUNC PyInit__mzcore(void) {
    if (!(s_empty = PyTuple_New(0))) return nullptr;
    return PyModule_Create(&moduledef);
}
