// C predict ABI implementation of the PyTorch port (see
// cpp/mxtpu_predict.h, which it shares with the JAX package's library).
//
// Reference parity: src/c_api/c_predict_api.cc.  The JAX package's
// cpp/mxtpu_predict.cc with one change: the predictor is a forked
// `python -m mxnet_tpu_torch.predict_worker`, driven over two pipes with
// a length-prefixed binary protocol (documented in that module).  A
// worker process rather than embedded CPython: no libpython link or
// version coupling for the host app, and crash isolation.

#include "mxtpu_predict.h"

#include <errno.h>
#include <signal.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <sys/types.h>
#include <sys/wait.h>
#include <unistd.h>

#include <string>
#include <vector>

#include "mxtpu_ipc.h"

namespace {

using mxtpu_ipc::append_u32;
using mxtpu_ipc::append_u64;
using mxtpu_ipc::parse_u32;

thread_local std::string g_last_error;

struct Predictor {
  mxtpu_ipc::Worker w;
  std::vector<std::vector<uint32_t>> output_shapes;
};

bool spawn_worker(Predictor *p) {
  return mxtpu_ipc::spawn_worker("mxnet_tpu_torch.predict_worker", &p->w,
                                 &g_last_error);
}

bool roundtrip(Predictor *p, uint8_t opcode, const std::string &payload,
               std::string *reply) {
  return mxtpu_ipc::roundtrip(p->w, opcode, payload, reply,
                              &g_last_error, "predict");
}

}  // namespace

extern "C" {

const char *mxtpu_predict_last_error(void) { return g_last_error.c_str(); }

int mxtpu_predict_create(const char *symbol_json, const void *param_bytes,
                         size_t param_len, uint32_t num_input_nodes,
                         const char **input_keys,
                         const uint32_t *input_shape_indptr,
                         const uint32_t *input_shape_data,
                         MXTPUPredictorHandle *out) {
  Predictor *p = new Predictor();
  if (!spawn_worker(p)) {
    delete p;
    return -1;
  }
  std::string payload;
  uint64_t jlen = strlen(symbol_json);
  append_u64(&payload, jlen);
  payload.append(symbol_json, jlen);
  append_u64(&payload, param_len);
  payload.append(static_cast<const char *>(param_bytes), param_len);
  append_u32(&payload, num_input_nodes);
  for (uint32_t i = 0; i < num_input_nodes; ++i) {
    uint32_t nlen = static_cast<uint32_t>(strlen(input_keys[i]));
    append_u32(&payload, nlen);
    payload.append(input_keys[i], nlen);
    uint32_t ndim = input_shape_indptr[i + 1] - input_shape_indptr[i];
    append_u32(&payload, ndim);
    for (uint32_t d = 0; d < ndim; ++d)
      append_u32(&payload, input_shape_data[input_shape_indptr[i] + d]);
  }
  std::string reply;
  if (!roundtrip(p, 1, payload, &reply)) {
    mxtpu_predict_free(p);
    return -1;
  }
  // bounds-checked parse: a corrupted reply must fail, not overread
  size_t off = 0;
  auto take_u32 = [&](uint32_t *v) {
    if (off + 4 > reply.size()) return false;
    *v = parse_u32(reply.data() + off);
    off += 4;
    return true;
  };
  uint32_t n_out = 0;
  bool parse_ok = take_u32(&n_out) && n_out <= 4096;
  if (parse_ok) {
    p->output_shapes.resize(n_out);
    for (uint32_t i = 0; parse_ok && i < n_out; ++i) {
      uint32_t ndim = 0;
      parse_ok = take_u32(&ndim) && ndim <= 64 &&
                 off + 4ull * ndim <= reply.size();
      if (parse_ok) {
        p->output_shapes[i].resize(ndim);
        for (uint32_t d = 0; d < ndim; ++d)
          p->output_shapes[i][d] = parse_u32(reply.data() + off + 4ull * d);
        off += 4ull * ndim;
      }
    }
  }
  if (!parse_ok) {
    g_last_error = "predict worker protocol corrupt (create reply)";
    mxtpu_predict_free(p);
    return -1;
  }
  *out = p;
  return 0;
}

int mxtpu_predict_set_input(MXTPUPredictorHandle h, const char *key,
                            const float *data, size_t size) {
  Predictor *p = static_cast<Predictor *>(h);
  std::string payload;
  uint32_t nlen = static_cast<uint32_t>(strlen(key));
  append_u32(&payload, nlen);
  payload.append(key, nlen);
  payload.append(reinterpret_cast<const char *>(data), size * 4);
  return roundtrip(p, 2, payload, nullptr) ? 0 : -1;
}

int mxtpu_predict_forward(MXTPUPredictorHandle h) {
  return roundtrip(static_cast<Predictor *>(h), 3, "", nullptr) ? 0 : -1;
}

int mxtpu_predict_get_output_shape(MXTPUPredictorHandle h, uint32_t index,
                                   uint32_t *shape_data, uint32_t cap,
                                   uint32_t *ndim) {
  Predictor *p = static_cast<Predictor *>(h);
  if (index >= p->output_shapes.size()) {
    g_last_error = "output index out of range";
    return -1;
  }
  const auto &s = p->output_shapes[index];
  *ndim = static_cast<uint32_t>(s.size());
  if (cap < s.size()) {
    g_last_error = "shape buffer too small";
    return -1;
  }
  memcpy(shape_data, s.data(), 4 * s.size());
  return 0;
}

int mxtpu_predict_get_output(MXTPUPredictorHandle h, uint32_t index,
                             float *data, size_t size) {
  Predictor *p = static_cast<Predictor *>(h);
  std::string payload, reply;
  append_u32(&payload, index);
  if (!roundtrip(p, 4, payload, &reply)) return -1;
  if (reply.size() != size * 4) {
    g_last_error = "output size mismatch: worker sent " +
                   std::to_string(reply.size() / 4) + " floats";
    return -1;
  }
  memcpy(data, reply.data(), reply.size());
  return 0;
}

int mxtpu_predict_reload_params(MXTPUPredictorHandle h,
                                const void *param_bytes, size_t param_len) {
  Predictor *p = static_cast<Predictor *>(h);
  std::string payload;
  append_u64(&payload, param_len);
  payload.append(static_cast<const char *>(param_bytes), param_len);
  return roundtrip(p, 5, payload, nullptr) ? 0 : -1;
}

void mxtpu_predict_free(MXTPUPredictorHandle h) {
  Predictor *p = static_cast<Predictor *>(h);
  if (!p) return;
  mxtpu_ipc::shutdown_worker(&p->w);
  delete p;
}

}  // extern "C"
