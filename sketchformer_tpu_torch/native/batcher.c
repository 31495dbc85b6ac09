/* Native host-side batch assembler for the training-input hot loop.
 *
 * The reference does per-batch tokenize+pad in per-sketch Python
 * (reference: dataloaders/distributed_stroke3.py + utils/tokenizer.py), which
 * SURVEY.md §3.1 marks as the host-side HOT LOOP. Feeding a TPU at
 * >50k sketches/sec leaves no room for a Python inner loop, so the whole
 * per-batch path — grid tokenization (cumsum -> bbox -> cell ids), SEP/EOS
 * interleaving, truncation and padding — runs here in one C pass over the
 * shard's ragged concat layout (points + offsets, exactly as stored on disk
 * by data/shards.py, so batches assemble without per-sketch slicing).
 *
 * Exposed functions (CPython C API + numpy, no pybind11):
 *   grid_encode_batch(points, offsets, resolution, max_len)
 *       -> (ids int32 (B, max_len), lengths int32 (B,))
 *   cont_batch(points, offsets, scale, max_len)
 *       -> (enc f32 (B,L,3), enc_mask f32 (B,L), dec_in f32 (B,L,5),
 *           tgt_xy f32 (B,L,2), tgt_pen i32 (B,L), dec_mask f32 (B,L))
 *
 * Semantics are bit-identical to the numpy reference implementations in
 * data/tokenizer.py / data/pipeline.py (float32 op order preserved); the
 * equivalence is pinned by tests/test_native.py.
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#define NPY_NO_DEPRECATED_API NPY_1_7_API_VERSION
#include <numpy/arrayobject.h>

#define PAD_ID 0
#define SOS_ID 1
#define EOS_ID 2
#define SEP_ID 3
#define NUM_SPECIAL 4

#define PEN_DOWN 0
#define PEN_LIFT 1
#define PEN_END 2

static int
check_inputs(PyArrayObject *points, PyArrayObject *offsets)
{
    if (PyArray_NDIM(points) != 2 || PyArray_DIM(points, 1) != 3 ||
        PyArray_TYPE(points) != NPY_FLOAT32) {
        PyErr_SetString(PyExc_ValueError, "points must be (P, 3) float32");
        return -1;
    }
    if (PyArray_NDIM(offsets) != 1 || PyArray_TYPE(offsets) != NPY_INT64) {
        PyErr_SetString(PyExc_ValueError, "offsets must be (B+1,) int64");
        return -1;
    }
    return 0;
}

/* --------------------------------------------------------------------- */

static PyObject *
grid_encode_batch(PyObject *self, PyObject *args)
{
    PyArrayObject *points, *offsets;
    int resolution, max_len;
    if (!PyArg_ParseTuple(args, "O!O!ii", &PyArray_Type, &points,
                          &PyArray_Type, &offsets, &resolution, &max_len))
        return NULL;
    if (check_inputs(points, offsets) < 0)
        return NULL;
    if (resolution < 2 || max_len < 2) {
        PyErr_SetString(PyExc_ValueError, "resolution>=2 and max_len>=2");
        return NULL;
    }
    npy_intp B = PyArray_DIM(offsets, 0) - 1;
    npy_intp P = PyArray_DIM(points, 0);
    const float *pts = (const float *)PyArray_DATA(points);
    const npy_int64 *off = (const npy_int64 *)PyArray_DATA(offsets);

    npy_intp ids_dims[2] = {B, max_len};
    npy_intp len_dims[1] = {B};
    PyArrayObject *ids_arr =
        (PyArrayObject *)PyArray_ZEROS(2, ids_dims, NPY_INT32, 0);
    PyArrayObject *len_arr =
        (PyArrayObject *)PyArray_ZEROS(1, len_dims, NPY_INT32, 0);
    if (!ids_arr || !len_arr) {
        Py_XDECREF(ids_arr);
        Py_XDECREF(len_arr);
        return NULL;
    }
    npy_int32 *ids = (npy_int32 *)PyArray_DATA(ids_arr);
    npy_int32 *lens = (npy_int32 *)PyArray_DATA(len_arr);

    /* scratch for one sketch's absolute coords */
    npy_intp max_pts = 0;
    for (npy_intp b = 0; b < B; b++) {
        npy_intp n = off[b + 1] - off[b];
        if (n > max_pts) max_pts = n;
        if (off[b] < 0 || off[b + 1] < off[b] || off[b + 1] > P) {
            Py_DECREF(ids_arr);
            Py_DECREF(len_arr);
            PyErr_SetString(PyExc_ValueError, "offsets out of range");
            return NULL;
        }
    }
    float *cx = (float *)PyMem_Malloc(sizeof(float) * (max_pts ? max_pts : 1));
    float *cy = (float *)PyMem_Malloc(sizeof(float) * (max_pts ? max_pts : 1));
    if (!cx || !cy) {
        PyMem_Free(cx);
        PyMem_Free(cy);
        Py_DECREF(ids_arr);
        Py_DECREF(len_arr);
        return PyErr_NoMemory();
    }

    Py_BEGIN_ALLOW_THREADS
    for (npy_intp b = 0; b < B; b++) {
        const float *sk = pts + 3 * off[b];
        npy_intp n = off[b + 1] - off[b];
        npy_int32 *row = ids + b * max_len;
        if (n == 0) {
            row[0] = EOS_ID;
            lens[b] = 1;
            continue;
        }
        /* cumsum + bbox, float32 op order matching numpy */
        float ax = 0.f, ay = 0.f;
        float lox = 0.f, loy = 0.f, hix = 0.f, hiy = 0.f;
        for (npy_intp i = 0; i < n; i++) {
            ax += sk[3 * i];
            ay += sk[3 * i + 1];
            cx[i] = ax;
            cy[i] = ay;
            if (i == 0) { lox = ax; loy = ay; hix = ax; hiy = ay; }
            else {
                if (ax < lox) lox = ax;
                if (ay < loy) loy = ay;
                if (ax > hix) hix = ax;
                if (ay > hiy) hiy = ay;
            }
        }
        float spanx = hix - lox, spany = hiy - loy;
        float span = spanx > spany ? spanx : spany;
        if (span < 1e-6f) span = 1e-6f;
        int r = resolution;
        int count = 0;
        int budget = max_len - 1; /* reserve EOS slot */
        for (npy_intp i = 0; i < n && count < budget; i++) {
            float ux = (cx[i] - lox) / span;
            float uy = (cy[i] - loy) / span;
            long gx = (long)(ux * (float)r);
            long gy = (long)(uy * (float)r);
            if (gx < 0) gx = 0;
            if (gx > r - 1) gx = r - 1;
            if (gy < 0) gy = 0;
            if (gy > r - 1) gy = r - 1;
            row[count++] = (npy_int32)(NUM_SPECIAL + gy * r + gx);
            if (sk[3 * i + 2] >= 0.5f && count < budget)
                row[count++] = SEP_ID;
        }
        row[count] = EOS_ID;
        lens[b] = count + 1;
    }
    Py_END_ALLOW_THREADS

    PyMem_Free(cx);
    PyMem_Free(cy);
    return Py_BuildValue("(NN)", ids_arr, len_arr);
}

/* --------------------------------------------------------------------- */

static PyObject *
cont_batch(PyObject *self, PyObject *args)
{
    PyArrayObject *points, *offsets;
    double scale_d;
    int max_len;
    if (!PyArg_ParseTuple(args, "O!O!di", &PyArray_Type, &points,
                          &PyArray_Type, &offsets, &scale_d, &max_len))
        return NULL;
    if (check_inputs(points, offsets) < 0)
        return NULL;
    npy_intp B = PyArray_DIM(offsets, 0) - 1;
    const float *pts = (const float *)PyArray_DATA(points);
    const npy_int64 *off = (const npy_int64 *)PyArray_DATA(offsets);
    float scale = (float)scale_d;
    npy_intp L = max_len;

    npy_intp d3[3] = {B, L, 3};
    npy_intp d2[2] = {B, L};
    npy_intp d5[3] = {B, L, 5};
    npy_intp dxy[3] = {B, L, 2};
    PyArrayObject *enc = (PyArrayObject *)PyArray_ZEROS(3, d3, NPY_FLOAT32, 0);
    PyArrayObject *enc_mask =
        (PyArrayObject *)PyArray_ZEROS(2, d2, NPY_FLOAT32, 0);
    PyArrayObject *dec_in = (PyArrayObject *)PyArray_ZEROS(3, d5, NPY_FLOAT32, 0);
    PyArrayObject *tgt_xy = (PyArrayObject *)PyArray_ZEROS(3, dxy, NPY_FLOAT32, 0);
    PyArrayObject *tgt_pen = (PyArrayObject *)PyArray_ZEROS(2, d2, NPY_INT32, 0);
    PyArrayObject *dec_mask =
        (PyArrayObject *)PyArray_ZEROS(2, d2, NPY_FLOAT32, 0);
    if (!enc || !enc_mask || !dec_in || !tgt_xy || !tgt_pen || !dec_mask) {
        Py_XDECREF(enc); Py_XDECREF(enc_mask); Py_XDECREF(dec_in);
        Py_XDECREF(tgt_xy); Py_XDECREF(tgt_pen); Py_XDECREF(dec_mask);
        return NULL;
    }
    float *e = (float *)PyArray_DATA(enc);
    float *em = (float *)PyArray_DATA(enc_mask);
    float *di = (float *)PyArray_DATA(dec_in);
    float *xy = (float *)PyArray_DATA(tgt_xy);
    npy_int32 *pen = (npy_int32 *)PyArray_DATA(tgt_pen);
    float *dm = (float *)PyArray_DATA(dec_mask);

    Py_BEGIN_ALLOW_THREADS
    for (npy_intp b = 0; b < B; b++) {
        const float *sk = pts + 3 * off[b];
        npy_intp n = off[b + 1] - off[b];
        if (n > L - 1) n = L - 1; /* reserve one row for PEN_END */
        npy_int32 *pen_row = pen + b * L;
        for (npy_intp t = 0; t < L; t++) pen_row[t] = PEN_END;
        for (npy_intp t = 0; t < n; t++) {
            float dx = sk[3 * t] / scale;
            float dy = sk[3 * t + 1] / scale;
            int lift = sk[3 * t + 2] >= 0.5f;
            e[(b * L + t) * 3] = dx;
            e[(b * L + t) * 3 + 1] = dy;
            e[(b * L + t) * 3 + 2] = sk[3 * t + 2];
            em[b * L + t] = 1.0f;
            xy[(b * L + t) * 2] = dx;
            xy[(b * L + t) * 2 + 1] = dy;
            pen_row[t] = lift ? PEN_LIFT : PEN_DOWN;
            dm[b * L + t] = 1.0f;
        }
        dm[b * L + n] = 1.0f; /* the PEN_END target row */
        /* dec_in: SOS row then shifted targets with one-hot pen */
        float *drow = di + b * L * 5;
        drow[3] = 1.0f; /* SOS = (0,0,0,1,0) */
        for (npy_intp t = 1; t <= n + 1 && t < L; t++) {
            drow[t * 5] = xy[(b * L + t - 1) * 2];
            drow[t * 5 + 1] = xy[(b * L + t - 1) * 2 + 1];
            /* one-hot only on real rows (pipeline zeroes padded rows) */
            if (dm[b * L + t - 1] > 0.5f)
                drow[t * 5 + 2 + pen_row[t - 1]] = 1.0f;
        }
    }
    Py_END_ALLOW_THREADS

    return Py_BuildValue("(NNNNNN)", enc, enc_mask, dec_in, tgt_xy, tgt_pen,
                         dec_mask);
}

/* --------------------------------------------------------------------- */

static PyMethodDef methods[] = {
    {"grid_encode_batch", grid_encode_batch, METH_VARARGS,
     "grid-tokenize + pad a ragged batch: (points, offsets, resolution, "
     "max_len) -> (ids, lengths)"},
    {"cont_batch", cont_batch, METH_VARARGS,
     "continuous-mode batch assembly: (points, offsets, scale, max_len) -> "
     "(enc, enc_mask, dec_in, tgt_xy, tgt_pen, dec_mask)"},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_batcher",
    "native batch assembly for sketchformer_tpu", -1, methods,
};

PyMODINIT_FUNC
PyInit__batcher(void)
{
    import_array();
    return PyModule_Create(&moduledef);
}
