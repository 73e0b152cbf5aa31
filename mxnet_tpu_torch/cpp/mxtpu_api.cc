// C train/NDArray ABI implementation of the PyTorch port (see
// cpp/mxtpu_api.h, which it shares with the JAX package's library).
//
// The JAX package's cpp/mxtpu_api.cc with one change: the worker it
// forks is `python -m mxnet_tpu_torch.api_worker`, which holds the
// ndarray/symbol/executor tables on the card; every call is one
// length-prefixed round-trip (protocol documented in that module).  No
// libpython linkage, crash isolation.  Built with cpp/mxtpu_runtime.cc
// and mxtpu_predict.cc into one libmxtpu_runtime.so by
// mxnet_tpu_torch/native.py.

#include "mxtpu_api.h"

#include <signal.h>
#include <sys/wait.h>

#include <string>
#include <vector>

#include "mxtpu_ipc.h"

namespace {

using mxtpu_ipc::append_u32;
using mxtpu_ipc::append_u64;
using mxtpu_ipc::parse_u32;
using mxtpu_ipc::parse_u64;

thread_local std::string g_last_error;

struct Session {
  mxtpu_ipc::Worker w;
};

bool call(Session *s, uint8_t op, const std::string &payload,
          std::string *reply) {
  return mxtpu_ipc::roundtrip(s->w, op, payload, reply, &g_last_error,
                              "api");
}

void append_str(std::string *p, const char *s) {
  uint32_t n = static_cast<uint32_t>(strlen(s));
  append_u32(p, n);
  p->append(s, n);
}

bool reply_handle(const std::string &reply, MXTPUHandle *out) {
  if (reply.size() != 8) {
    g_last_error = "api worker protocol corrupt (handle reply)";
    return false;
  }
  *out = parse_u64(reply.data());
  return true;
}

// parse a u32-count-prefixed handle list into out (capped)
bool reply_handles(const std::string &reply, MXTPUHandle *out,
                   uint32_t cap, uint32_t *n_out) {
  if (reply.size() < 4) {
    g_last_error = "api worker protocol corrupt (handle list)";
    return false;
  }
  uint32_t n = parse_u32(reply.data());
  if (reply.size() != 4 + 8ull * n || n > 65536) {
    g_last_error = "api worker protocol corrupt (handle list)";
    return false;
  }
  if (n > cap) {
    g_last_error = "output handle buffer too small";
    return false;
  }
  for (uint32_t i = 0; i < n; ++i)
    out[i] = parse_u64(reply.data() + 4 + 8ull * i);
  *n_out = n;
  return true;
}

}  // namespace

extern "C" {

const char *mxtpu_api_last_error(void) { return g_last_error.c_str(); }

int MXTPUSessionCreate(MXTPUSessionHandle *out) {
  Session *s = new Session();
  if (!mxtpu_ipc::spawn_worker("mxnet_tpu_torch.api_worker", &s->w,
                               &g_last_error)) {
    delete s;
    return -1;
  }
  *out = s;
  return 0;
}

int MXTPUSessionFree(MXTPUSessionHandle sess) {
  Session *s = static_cast<Session *>(sess);
  if (!s) return 0;
  mxtpu_ipc::shutdown_worker(&s->w);
  delete s;
  return 0;
}

/* -- ndarray ------------------------------------------------------------ */

int MXTPUNDArrayCreate(MXTPUSessionHandle sess, const uint32_t *dims,
                       uint32_t ndim, int dtype, int ones,
                       MXTPUHandle *out) {
  std::string p, reply;
  p.push_back(static_cast<char>(dtype));
  p.push_back(static_cast<char>(ones ? 1 : 0));
  append_u32(&p, ndim);
  for (uint32_t i = 0; i < ndim; ++i) append_u32(&p, dims[i]);
  if (!call(static_cast<Session *>(sess), 1, p, &reply)) return -1;
  return reply_handle(reply, out) ? 0 : -1;
}

int MXTPUNDArrayFromData(MXTPUSessionHandle sess, const uint32_t *dims,
                         uint32_t ndim, int dtype, const void *data,
                         size_t nbytes, MXTPUHandle *out) {
  std::string p, reply;
  p.push_back(static_cast<char>(dtype));
  append_u32(&p, ndim);
  for (uint32_t i = 0; i < ndim; ++i) append_u32(&p, dims[i]);
  p.append(static_cast<const char *>(data), nbytes);
  if (!call(static_cast<Session *>(sess), 2, p, &reply)) return -1;
  return reply_handle(reply, out) ? 0 : -1;
}

int MXTPUNDArrayToHost(MXTPUSessionHandle sess, MXTPUHandle h, void *buf,
                       size_t nbytes) {
  std::string p, reply;
  append_u64(&p, h);
  if (!call(static_cast<Session *>(sess), 3, p, &reply)) return -1;
  if (reply.size() != nbytes) {
    g_last_error = "tensor size mismatch: worker sent " +
                   std::to_string(reply.size()) + " bytes, caller asked " +
                   std::to_string(nbytes);
    return -1;
  }
  memcpy(buf, reply.data(), nbytes);
  return 0;
}

int MXTPUNDArrayShape(MXTPUSessionHandle sess, MXTPUHandle h,
                      uint32_t *dims, uint32_t cap, uint32_t *ndim) {
  std::string p, reply;
  append_u64(&p, h);
  if (!call(static_cast<Session *>(sess), 4, p, &reply)) return -1;
  if (reply.size() < 4) {
    g_last_error = "api worker protocol corrupt (shape reply)";
    return -1;
  }
  uint32_t nd = parse_u32(reply.data());
  if (reply.size() != 4 + 4ull * nd || nd > 64) {
    g_last_error = "api worker protocol corrupt (shape reply)";
    return -1;
  }
  *ndim = nd;
  if (nd > cap) {
    g_last_error = "shape buffer too small";
    return -1;
  }
  for (uint32_t i = 0; i < nd; ++i)
    dims[i] = parse_u32(reply.data() + 4 + 4ull * i);
  return 0;
}

int MXTPUNDArrayCopyFromCPU(MXTPUSessionHandle sess, MXTPUHandle h,
                            const void *data, size_t nbytes) {
  std::string p;
  append_u64(&p, h);
  p.append(static_cast<const char *>(data), nbytes);
  return call(static_cast<Session *>(sess), 17, p, nullptr) ? 0 : -1;
}

int MXTPUNDArrayFree(MXTPUSessionHandle sess, MXTPUHandle h) {
  std::string p;
  append_u64(&p, h);
  return call(static_cast<Session *>(sess), 5, p, nullptr) ? 0 : -1;
}

/* -- imperative invoke -------------------------------------------------- */

int MXTPUImperativeInvoke(MXTPUSessionHandle sess, const char *op,
                          uint32_t n_in, const MXTPUHandle *in,
                          uint32_t n_attr, const char *const *keys,
                          const char *const *vals, MXTPUHandle *out,
                          uint32_t out_cap, uint32_t *n_out) {
  std::string p, reply;
  append_str(&p, op);
  append_u32(&p, n_in);
  for (uint32_t i = 0; i < n_in; ++i) append_u64(&p, in[i]);
  append_u32(&p, n_attr);
  for (uint32_t i = 0; i < n_attr; ++i) {
    append_str(&p, keys[i]);
    append_str(&p, vals[i]);
  }
  if (!call(static_cast<Session *>(sess), 6, p, &reply)) return -1;
  return reply_handles(reply, out, out_cap, n_out) ? 0 : -1;
}

/* -- symbol ------------------------------------------------------------- */

int MXTPUSymbolFromJSON(MXTPUSessionHandle sess, const char *json,
                        MXTPUHandle *out) {
  std::string reply;
  if (!call(static_cast<Session *>(sess), 7, json, &reply)) return -1;
  return reply_handle(reply, out) ? 0 : -1;
}

int MXTPUSymbolFromFile(MXTPUSessionHandle sess, const char *path,
                        MXTPUHandle *out) {
  FILE *f = fopen(path, "rb");
  if (!f) {
    g_last_error = std::string("cannot open ") + path;
    return -1;
  }
  std::string json;
  char buf[65536];
  size_t n;
  while ((n = fread(buf, 1, sizeof(buf), f)) > 0) json.append(buf, n);
  fclose(f);
  return MXTPUSymbolFromJSON(sess, json.c_str(), out);
}

int MXTPUSymbolListArguments(MXTPUSessionHandle sess, MXTPUHandle sym,
                             char *buf, size_t cap) {
  std::string p, reply;
  append_u64(&p, sym);
  if (!call(static_cast<Session *>(sess), 8, p, &reply)) return -1;
  if (reply.size() < 4) {
    g_last_error = "api worker protocol corrupt (args reply)";
    return -1;
  }
  uint32_t n = parse_u32(reply.data());
  size_t off = 4, w = 0;
  for (uint32_t i = 0; i < n; ++i) {
    if (off + 4 > reply.size()) {
      g_last_error = "api worker protocol corrupt (args reply)";
      return -1;
    }
    uint32_t len = parse_u32(reply.data() + off);
    off += 4;
    if (off + len > reply.size()) {
      g_last_error = "api worker protocol corrupt (args reply)";
      return -1;
    }
    if (w + len + 2 > cap) {
      g_last_error = "argument name buffer too small";
      return -1;
    }
    if (i) buf[w++] = '\n';
    memcpy(buf + w, reply.data() + off, len);
    w += len;
    off += len;
  }
  // the loop's per-name check reserves NUL space only when n > 0; a
  // zero-argument symbol reaches here with w == 0 and an unchecked
  // write would be out of bounds for cap == 0
  if (w >= cap) {
    g_last_error = "argument name buffer too small";
    return -1;
  }
  buf[w] = '\0';
  return 0;
}

int MXTPUSymbolInferShape(MXTPUSessionHandle sess, MXTPUHandle sym,
                          uint32_t n_provided, const char *const *names,
                          const uint32_t *ndims,
                          const uint32_t *dims_concat,
                          uint32_t *arg_ndims, uint32_t arg_cap,
                          uint32_t *arg_dims_concat,
                          uint32_t arg_dims_cap, uint32_t *n_args,
                          uint32_t *out_ndims, uint32_t out_cap,
                          uint32_t *out_dims_concat,
                          uint32_t out_dims_cap, uint32_t *n_outputs) {
  std::string p, reply;
  append_u64(&p, sym);
  append_u32(&p, n_provided);
  const uint32_t *d = dims_concat;
  for (uint32_t i = 0; i < n_provided; ++i) {
    append_str(&p, names[i]);
    append_u32(&p, ndims[i]);
    for (uint32_t k = 0; k < ndims[i]; ++k) append_u32(&p, *d++);
  }
  if (!call(static_cast<Session *>(sess), 9, p, &reply)) return -1;

  size_t off = 0;
  g_last_error.clear();  // so the generic fallback below can detect
                         // whether take_group set a specific message
  auto take_group = [&](uint32_t *ndims_out, uint32_t entry_cap,
                        uint32_t *dims_out, uint32_t dims_cap,
                        uint32_t *count) {
    if (off + 4 > reply.size()) return false;
    uint32_t n = parse_u32(reply.data() + off);
    off += 4;
    // entry count is attacker/worker-controlled: bound it by the
    // caller's buffer BEFORE any write (stack-smash guard)
    if (n > entry_cap) {
      g_last_error = "infer-shape buffers too small (need " +
                     std::to_string(n) + " entries)";
      return false;
    }
    uint32_t written = 0;
    for (uint32_t i = 0; i < n; ++i) {
      if (off + 4 > reply.size()) return false;
      uint32_t nd = parse_u32(reply.data() + off);
      off += 4;
      if (off + 4ull * nd > reply.size() || nd > 64) return false;
      ndims_out[i] = nd;
      for (uint32_t k = 0; k < nd; ++k) {
        if (written >= dims_cap) return false;
        dims_out[written] = parse_u32(reply.data() + off);
        ++written;
        off += 4;
      }
    }
    *count = n;
    return true;
  };
  if (!take_group(arg_ndims, arg_cap, arg_dims_concat, arg_dims_cap,
                  n_args) ||
      !take_group(out_ndims, out_cap, out_dims_concat, out_dims_cap,
                  n_outputs)) {
    if (g_last_error.empty())
      g_last_error = "api worker protocol corrupt (infer-shape reply)";
    return -1;
  }
  return 0;
}

int MXTPUSymbolFree(MXTPUSessionHandle sess, MXTPUHandle sym) {
  std::string p;
  append_u64(&p, sym);
  return call(static_cast<Session *>(sess), 15, p, nullptr) ? 0 : -1;
}

/* -- executor ----------------------------------------------------------- */

int MXTPUExecutorBind(MXTPUSessionHandle sess, MXTPUHandle sym,
                      uint32_t n_args, const char *const *arg_names,
                      const MXTPUHandle *arg_handles, uint32_t n_aux,
                      const char *const *aux_names,
                      const MXTPUHandle *aux_handles, int with_grad,
                      MXTPUHandle *out) {
  std::string p, reply;
  append_u64(&p, sym);
  append_u32(&p, n_args);
  for (uint32_t i = 0; i < n_args; ++i) {
    append_str(&p, arg_names[i]);
    append_u64(&p, arg_handles[i]);
  }
  append_u32(&p, n_aux);
  for (uint32_t i = 0; i < n_aux; ++i) {
    append_str(&p, aux_names[i]);
    append_u64(&p, aux_handles[i]);
  }
  p.push_back(static_cast<char>(with_grad ? 1 : 0));
  if (!call(static_cast<Session *>(sess), 10, p, &reply)) return -1;
  return reply_handle(reply, out) ? 0 : -1;
}

int MXTPUExecutorForward(MXTPUSessionHandle sess, MXTPUHandle exec,
                         int is_train, MXTPUHandle *outputs,
                         uint32_t cap, uint32_t *n_out) {
  std::string p, reply;
  append_u64(&p, exec);
  p.push_back(static_cast<char>(is_train ? 1 : 0));
  if (!call(static_cast<Session *>(sess), 11, p, &reply)) return -1;
  return reply_handles(reply, outputs, cap, n_out) ? 0 : -1;
}

int MXTPUExecutorBackward(MXTPUSessionHandle sess, MXTPUHandle exec,
                          uint32_t n_heads, const MXTPUHandle *heads) {
  std::string p;
  append_u64(&p, exec);
  append_u32(&p, n_heads);
  for (uint32_t i = 0; i < n_heads; ++i) append_u64(&p, heads[i]);
  return call(static_cast<Session *>(sess), 12, p, nullptr) ? 0 : -1;
}

int MXTPUExecutorArgGrad(MXTPUSessionHandle sess, MXTPUHandle exec,
                         const char *arg_name, MXTPUHandle *out) {
  std::string p, reply;
  append_u64(&p, exec);
  append_str(&p, arg_name);
  if (!call(static_cast<Session *>(sess), 13, p, &reply)) return -1;
  return reply_handle(reply, out) ? 0 : -1;
}

int MXTPUExecutorFree(MXTPUSessionHandle sess, MXTPUHandle exec) {
  std::string p;
  append_u64(&p, exec);
  return call(static_cast<Session *>(sess), 16, p, nullptr) ? 0 : -1;
}

/* -- misc --------------------------------------------------------------- */

int MXTPURandomSeed(MXTPUSessionHandle sess, uint64_t seed) {
  std::string p;
  append_u64(&p, seed);
  return call(static_cast<Session *>(sess), 14, p, nullptr) ? 0 : -1;
}

}  // extern "C"
