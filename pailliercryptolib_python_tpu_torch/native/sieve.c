/* Native keygen helpers: windowed trial-division sieve + limb packing.
 *
 * TPU-native counterpart of the native code paths the reference keeps in
 * C++ (the IPCL crypto core's primality search feeding
 * ipcl::generateKeypair, and the bindings' byte<->limb converters,
 * the reference's src/ipcl_python/bindings/ipcl_bindings.cpp:100-138).
 * This file is the PyTorch port's own copy of the JAX package's
 * native/sieve.c; the code is the same.
 * The device does bulk modexp; the host-side hot loops that remain —
 * sieving prime candidates and packing big integers into limb buffers —
 * live here as a plain CPython C extension (no pybind11 dependency).
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

/* sieve_window(base_le_bytes, count, primes_tuple) -> bytearray mask
 *
 * base must be odd.  Considers the `count` odd candidates
 * base, base+2, base+4, ... base+2*(count-1) and returns mask[i] == 1
 * when candidate i has no divisor among `primes`.
 */
static PyObject *
sieve_window(PyObject *self, PyObject *args)
{
    Py_buffer base;
    Py_ssize_t count;
    PyObject *primes;

    if (!PyArg_ParseTuple(args, "y*nO", &base, &count, &primes))
        return NULL;

    PyObject *mask = PyByteArray_FromStringAndSize(NULL, count);
    if (!mask) {
        PyBuffer_Release(&base);
        return NULL;
    }
    char *m = PyByteArray_AS_STRING(mask);
    memset(m, 1, (size_t)count);

    PyObject *seq = PySequence_Fast(primes, "primes must be a sequence");
    if (!seq) {
        PyBuffer_Release(&base);
        Py_DECREF(mask);
        return NULL;
    }
    Py_ssize_t np = PySequence_Fast_GET_SIZE(seq);
    const uint8_t *b = (const uint8_t *)base.buf;
    Py_ssize_t nb = base.len;

    for (Py_ssize_t k = 0; k < np; k++) {
        long p = PyLong_AsLong(PySequence_Fast_GET_ITEM(seq, k));
        if (p <= 2)
            continue;
        /* r = base mod p, big-endian scan of the little-endian buffer */
        uint64_t r = 0;
        for (Py_ssize_t i = nb - 1; i >= 0; i--)
            r = ((r << 8) | b[i]) % (uint64_t)p;
        /* smallest j >= 0 with (base + 2j) % p == 0:
         * j = (p - r) * inv2 mod p, inv2 = (p+1)/2 */
        uint64_t need = ((uint64_t)p - r) % (uint64_t)p;
        uint64_t inv2 = ((uint64_t)p + 1) / 2;
        uint64_t j = (need * inv2) % (uint64_t)p;
        for (; j < (uint64_t)count; j += (uint64_t)p) {
            /* candidate equal to p itself stays prime */
            if (r == 0 && j == 0 && nb <= 8) {
                uint64_t v = 0;
                for (Py_ssize_t i = nb - 1; i >= 0; i--)
                    v = (v << 8) | b[i];
                if (v == (uint64_t)p)
                    continue;
            }
            m[j] = 0;
        }
    }

    Py_DECREF(seq);
    PyBuffer_Release(&base);
    return mask;
}

/* pack_limbs16(concat_bytes, count, limbs) -> bytes
 *
 * Reinterpret `count` fixed-width little-endian integers (limbs*2 bytes
 * each) as an interleaved (limbs, count) uint32 buffer of 16-bit limbs —
 * the device layout — in one pass. */
static PyObject *
pack_limbs16(PyObject *self, PyObject *args)
{
    Py_buffer buf;
    Py_ssize_t count, limbs;

    if (!PyArg_ParseTuple(args, "y*nn", &buf, &count, &limbs))
        return NULL;
    if (buf.len < count * limbs * 2) {
        PyBuffer_Release(&buf);
        PyErr_SetString(PyExc_ValueError, "pack_limbs16: buffer too small");
        return NULL;
    }
    PyObject *out = PyBytes_FromStringAndSize(NULL, count * limbs * 4);
    if (!out) {
        PyBuffer_Release(&buf);
        return NULL;
    }
    uint32_t *o = (uint32_t *)PyBytes_AS_STRING(out);
    const uint8_t *src = (const uint8_t *)buf.buf;
    for (Py_ssize_t c = 0; c < count; c++) {
        const uint8_t *row = src + c * limbs * 2;
        for (Py_ssize_t l = 0; l < limbs; l++) {
            uint16_t v = (uint16_t)(row[2 * l] | (row[2 * l + 1] << 8));
            o[l * count + c] = v;  /* limbs-major */
        }
    }
    PyBuffer_Release(&buf);
    return out;
}

/* pack_ints16(seq, limbs) -> bytes
 *
 * Serialize a sequence of non-negative Python ints straight into the
 * limbs-major (limbs, count) uint32 device layout — the C path for
 * ints_to_limbs, replacing the Python-level to_bytes join.  Ints must
 * fit limbs*16 bits. */
static PyObject *
pack_ints16(PyObject *self, PyObject *args)
{
    PyObject *seq_in;
    Py_ssize_t limbs;

    if (!PyArg_ParseTuple(args, "On", &seq_in, &limbs))
        return NULL;
    PyObject *seq = PySequence_Fast(seq_in, "pack_ints16: need a sequence");
    if (!seq)
        return NULL;
    Py_ssize_t count = PySequence_Fast_GET_SIZE(seq);
    PyObject *out = PyBytes_FromStringAndSize(NULL, count * limbs * 4);
    if (!out) {
        Py_DECREF(seq);
        return NULL;
    }
    uint32_t *o = (uint32_t *)PyBytes_AS_STRING(out);
    uint8_t *row = (uint8_t *)PyMem_Malloc((size_t)limbs * 2);
    if (!row) {
        Py_DECREF(seq);
        Py_DECREF(out);
        return PyErr_NoMemory();
    }
    for (Py_ssize_t c = 0; c < count; c++) {
        PyObject *item = PySequence_Fast_GET_ITEM(seq, c);
        if (!PyLong_Check(item)) {
            PyMem_Free(row);
            Py_DECREF(seq);
            Py_DECREF(out);
            PyErr_SetString(PyExc_TypeError, "pack_ints16: non-int item");
            return NULL;
        }
        if (_PyLong_AsByteArray((PyLongObject *)item, row,
                                (size_t)limbs * 2, 1, 0
#if PY_VERSION_HEX >= 0x030D0000
                                , 1
#endif
                                ) < 0) {
            PyMem_Free(row);
            Py_DECREF(seq);
            Py_DECREF(out);
            return NULL;  /* negative or overflowing value */
        }
        for (Py_ssize_t l = 0; l < limbs; l++)
            o[l * count + c] =
                (uint32_t)(row[2 * l] | (row[2 * l + 1] << 8));
    }
    PyMem_Free(row);
    Py_DECREF(seq);
    return out;
}

/* unpack_ints16(buf, count, limbs) -> list of ints
 *
 * Inverse of pack_ints16: limbs-major (limbs, count) uint32 buffer of
 * canonical 16-bit limbs -> list of Python ints (decrypt host tail). */
static PyObject *
unpack_ints16(PyObject *self, PyObject *args)
{
    Py_buffer buf;
    Py_ssize_t count, limbs;

    if (!PyArg_ParseTuple(args, "y*nn", &buf, &count, &limbs))
        return NULL;
    if (buf.len < count * limbs * 4) {
        PyBuffer_Release(&buf);
        PyErr_SetString(PyExc_ValueError, "unpack_ints16: buffer too small");
        return NULL;
    }
    const uint32_t *src = (const uint32_t *)buf.buf;
    PyObject *out = PyList_New(count);
    if (!out) {
        PyBuffer_Release(&buf);
        return NULL;
    }
    uint8_t *row = (uint8_t *)PyMem_Malloc((size_t)limbs * 2);
    if (!row) {
        PyBuffer_Release(&buf);
        Py_DECREF(out);
        return PyErr_NoMemory();
    }
    for (Py_ssize_t c = 0; c < count; c++) {
        for (Py_ssize_t l = 0; l < limbs; l++) {
            uint32_t v = src[l * count + c];
            row[2 * l] = (uint8_t)(v & 0xFF);
            row[2 * l + 1] = (uint8_t)((v >> 8) & 0xFF);
        }
        PyObject *n = _PyLong_FromByteArray(row, (size_t)limbs * 2, 1, 0);
        if (!n) {
            PyMem_Free(row);
            PyBuffer_Release(&buf);
            Py_DECREF(out);
            return NULL;
        }
        PyList_SET_ITEM(out, c, n);
    }
    PyMem_Free(row);
    PyBuffer_Release(&buf);
    return out;
}

/* extract_windows(buf, count, rbytes, window, n_win) -> bytes
 *
 * buf holds `count` rows of `rbytes` little-endian bytes (one random
 * exponent per row).  Returns the (n_win, count) uint32 limbs-major
 * buffer with out[w, c] = bits [w*window, (w+1)*window) of row c —
 * the DJN obfuscator digit extraction (window <= 16). */
static PyObject *
extract_windows(PyObject *self, PyObject *args)
{
    Py_buffer buf;
    Py_ssize_t count, rbytes, window, n_win;

    if (!PyArg_ParseTuple(args, "y*nnnn", &buf, &count, &rbytes, &window,
                          &n_win))
        return NULL;
    if (buf.len < count * rbytes || window < 1 || window > 16) {
        PyBuffer_Release(&buf);
        PyErr_SetString(PyExc_ValueError, "extract_windows: bad args");
        return NULL;
    }
    PyObject *out = PyBytes_FromStringAndSize(NULL, n_win * count * 4);
    if (!out) {
        PyBuffer_Release(&buf);
        return NULL;
    }
    uint32_t *o = (uint32_t *)PyBytes_AS_STRING(out);
    const uint8_t *src = (const uint8_t *)buf.buf;
    uint32_t mask = (window == 32) ? 0xFFFFFFFFu : ((1u << window) - 1u);
    for (Py_ssize_t c = 0; c < count; c++) {
        const uint8_t *row = src + c * rbytes;
        for (Py_ssize_t w = 0; w < n_win; w++) {
            size_t bit = (size_t)w * (size_t)window;
            size_t byte = bit >> 3;
            int off = (int)(bit & 7);
            uint32_t v = 0;
            for (int k = 0; k < 4 && byte + (size_t)k < (size_t)rbytes; k++)
                v |= (uint32_t)row[byte + k] << (8 * k);
            o[(size_t)w * count + c] = (v >> off) & mask;
        }
    }
    PyBuffer_Release(&buf);
    return out;
}

/* -- fixed-point decode, C path ------------------------------------------ */

/* compare little-endian byte strings of equal length: -1 / 0 / +1 */
static int
cmp_le(const uint8_t *a, const uint8_t *b, Py_ssize_t nb)
{
    for (Py_ssize_t i = nb - 1; i >= 0; i--) {
        if (a[i] != b[i])
            return a[i] < b[i] ? -1 : 1;
    }
    return 0;
}

/* out = a - b on little-endian byte strings (requires a >= b) */
static void
sub_le(uint8_t *out, const uint8_t *a, const uint8_t *b, Py_ssize_t nb)
{
    int borrow = 0;
    for (Py_ssize_t i = 0; i < nb; i++) {
        int d = (int)a[i] - (int)b[i] - borrow;
        borrow = d < 0;
        out[i] = (uint8_t)(d & 0xFF);
    }
}

/* decode_limbs16(buf, count, stride, limbs, exps, n_le, max_int_le,
 *                n_minus_max_le) -> list
 *
 * The decrypt host tail in one C pass: buf is the (limbs, stride) uint32
 * limbs-major canonical plaintext array (first `count` columns valid),
 * exps `count` int64 fixed-point exponents, and n / max_int /
 * n - max_int as little-endian buffers of limbs*2 bytes.  Per element
 * this reproduces FixedPointNumber.decode exactly (reference
 * bindings/fixedpoint.py:98-115): encoding <= max_int -> positive,
 * >= n - max_int -> negative (mantissa = encoding - n), else
 * OverflowError; result = mantissa * 2^-exponent with CPython's own
 * int->float rounding (PyLong_AsDouble) so values match the Python
 * loop bit-for-bit, including exact int results for exponent <= 0.
 */
static PyObject *
decode_limbs16(PyObject *self, PyObject *args)
{
    Py_buffer buf, exps, nle, mle, nmle;
    Py_ssize_t count, stride, limbs;

    if (!PyArg_ParseTuple(args, "y*nnny*y*y*y*", &buf, &count, &stride,
                          &limbs, &exps, &nle, &mle, &nmle))
        return NULL;
    Py_ssize_t nb = limbs * 2;
    if (buf.len < stride * limbs * 4 || exps.len < count * 8 ||
        nle.len != nb || mle.len != nb || nmle.len != nb ||
        count > stride) {
        PyErr_SetString(PyExc_ValueError, "decode_limbs16: bad args");
        goto fail_release;
    }
    {
    const uint32_t *src = (const uint32_t *)buf.buf;
    const int64_t *ev = (const int64_t *)exps.buf;
    const uint8_t *nB = (const uint8_t *)nle.buf;
    const uint8_t *mB = (const uint8_t *)mle.buf;
    const uint8_t *nmB = (const uint8_t *)nmle.buf;
    PyObject *out = PyList_New(count);
    uint8_t *row = NULL, *mant = NULL;
    if (!out)
        goto fail_release;
    row = (uint8_t *)PyMem_Malloc((size_t)nb);
    mant = (uint8_t *)PyMem_Malloc((size_t)nb);
    if (!row || !mant) {
        PyErr_NoMemory();
        goto fail;
    }
    for (Py_ssize_t c = 0; c < count; c++) {
        for (Py_ssize_t l = 0; l < limbs; l++) {
            uint32_t v = src[l * stride + c];
            row[2 * l] = (uint8_t)(v & 0xFF);
            row[2 * l + 1] = (uint8_t)((v >> 8) & 0xFF);
        }
        if (cmp_le(row, nB, nb) >= 0) {
            PyErr_SetString(PyExc_ValueError,
                            "Attempted to decode corrupted number");
            goto fail;
        }
        int neg = 0;
        if (cmp_le(row, mB, nb) <= 0) {
            memcpy(mant, row, (size_t)nb);
        } else if (cmp_le(row, nmB, nb) >= 0) {
            neg = 1;
            sub_le(mant, nB, row, nb); /* |encoding - n| */
        } else {
            PyObject *encO = _PyLong_FromByteArray(row, (size_t)nb, 1, 0);
            PyObject *nO = _PyLong_FromByteArray(nB, (size_t)nb, 1, 0);
            if (encO && nO)
                PyErr_Format(PyExc_OverflowError,
                             "Overflow detected in decode number, "
                             "encoding: %S, %lld %S",
                             encO, (long long)ev[c], nO);
            Py_XDECREF(encO);
            Py_XDECREF(nO);
            goto fail;
        }
        int64_t e = ev[c];
        PyObject *res;
        if (e <= 0) {
            /* mantissa * BASE^-e is an exact Python int */
            PyObject *v = _PyLong_FromByteArray(mant, (size_t)nb, 1, 0);
            if (!v)
                goto fail;
            if (e < 0) {
                PyObject *sh = PyLong_FromLongLong(-e);
                PyObject *t = sh ? PyNumber_Lshift(v, sh) : NULL;
                Py_XDECREF(sh);
                Py_DECREF(v);
                if (!t)
                    goto fail;
                v = t;
            }
            if (neg) {
                PyObject *t = PyNumber_Negative(v);
                Py_DECREF(v);
                if (!t)
                    goto fail;
                v = t;
            }
            res = v;
        } else {
            PyObject *v = _PyLong_FromByteArray(mant, (size_t)nb, 1, 0);
            if (!v)
                goto fail;
            double d = PyLong_AsDouble(v);
            Py_DECREF(v);
            if (d == -1.0 && PyErr_Occurred())
                goto fail; /* same OverflowError as int * float */
            if (neg)
                d = -d;
            /* CPython: mantissa * pow(2, -e); pow underflows to 0.0
             * past the subnormal range, ldexp(1,-e) matches within it */
            double factor = (e <= 1074) ? ldexp(1.0, (int)-e) : 0.0;
            res = PyFloat_FromDouble(d * factor);
            if (!res)
                goto fail;
        }
        PyList_SET_ITEM(out, c, res);
    }
    PyMem_Free(row);
    PyMem_Free(mant);
    PyBuffer_Release(&buf);
    PyBuffer_Release(&exps);
    PyBuffer_Release(&nle);
    PyBuffer_Release(&mle);
    PyBuffer_Release(&nmle);
    return out;
fail:
    PyMem_Free(row);
    PyMem_Free(mant);
    Py_DECREF(out);
    }
fail_release:
    PyBuffer_Release(&buf);
    PyBuffer_Release(&exps);
    PyBuffer_Release(&nle);
    PyBuffer_Release(&mle);
    PyBuffer_Release(&nmle);
    return NULL;
}

static PyMethodDef Methods[] = {
    {"sieve_window", sieve_window, METH_VARARGS,
     "Trial-division sieve over a window of odd candidates."},
    {"pack_limbs16", pack_limbs16, METH_VARARGS,
     "Pack fixed-width little-endian ints into limbs-major uint32."},
    {"pack_ints16", pack_ints16, METH_VARARGS,
     "Serialize Python ints straight into limbs-major uint32."},
    {"unpack_ints16", unpack_ints16, METH_VARARGS,
     "Limbs-major uint32 canonical limbs -> list of Python ints."},
    {"extract_windows", extract_windows, METH_VARARGS,
     "Bit-window digit extraction from row-major byte buffers."},
    {"decode_limbs16", decode_limbs16, METH_VARARGS,
     "Limbs-major plaintext array -> decoded fixed-point numbers."},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_paillier_native", NULL, -1, Methods,
};

PyMODINIT_FUNC
PyInit__paillier_native(void)
{
    return PyModule_Create(&moduledef);
}
