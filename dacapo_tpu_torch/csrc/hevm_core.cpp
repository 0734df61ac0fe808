// hevm_core: native runtime core for the TPU HEVM artifact layer.
//
// C++ counterparts of the reference's native runtime pieces, operating on
// the same binary formats:
//   * .hevm bytecode load/save   (reference: lib/Runtime/SEAL_HEVM.cpp:202-234
//     read side, lib/Dialect/CKKS/Transforms/EmitHEVM.cpp:109-119 write side,
//     layout include/hecate/Support/HEVMHeader.h:10-35)
//   * .cst constant pool load/save (reference: ElideConstant.cpp:40-53,
//     SEAL_HEVM.cpp:182-200)
//   * bytecode validation (operand-initialized / bounds / opcode checks —
//     the reference VM trusts its input; we don't)
//   * liveness-based cipher register reuse over the instruction stream
//     (reference: lib/Dialect/CKKS/Transforms/ReuseBuffer.cpp:27-55, done
//     there on MLIR; here directly on bytecode so it can re-compact any
//     .hevm artifact)
//
// Exposed as a C ABI for ctypes (dacapo_tpu/vm/native.py). All functions are
// thread-compatible: no global state, one handle per program.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

constexpr uint32_t kMagic = 0x4845564D;  // 'HEVM'

enum Opcode : uint16_t {
  OP_ENCODE = 0, OP_ROTATE = 1, OP_NEGATE = 2, OP_RESCALE = 3,
  OP_MODSWITCH = 4, OP_UPSCALE = 5, OP_ADDCC = 6, OP_ADDCP = 7,
  OP_MULCC = 8, OP_MULCP = 9, OP_BOOTSTRAP = 10,
  OP_ALLOC = 0xFFFF,
};

struct Op {
  uint16_t opcode, dst, lhs, rhs;
};

struct Program {
  uint64_t init_level = 0;
  uint64_t num_ctxt = 0, num_ptxt = 0;
  std::vector<uint64_t> arg_scale, arg_level;
  std::vector<uint64_t> res_scale, res_level, res_dst;
  std::vector<Op> ops;
};

struct Cst {
  std::vector<uint64_t> offsets;  // prefix offsets into data
  std::vector<double> data;
};

bool read_u64s(FILE* f, uint64_t n, std::vector<uint64_t>* out) {
  out->resize(n);
  return n == 0 || std::fread(out->data(), 8, n, f) == n;
}

}  // namespace

extern "C" {

// ------------------------------------------------------------------ .hevm
void* hevm_load(const char* path) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return nullptr;
  uint32_t magic = 0, hdr_size = 0;
  uint64_t argn = 0, resn = 0;
  uint64_t body[5] = {0};  // body_len, nops, nct, npt, init_level
  Program* p = new Program();
  bool ok = std::fread(&magic, 4, 1, f) == 1 &&
            std::fread(&hdr_size, 4, 1, f) == 1 && magic == kMagic &&
            std::fread(&argn, 8, 1, f) == 1 &&
            std::fread(&resn, 8, 1, f) == 1 &&
            std::fread(body, 8, 5, f) == 5 &&
            argn < (1u << 20) && resn < (1u << 20) && body[1] < (1u << 28) &&
            read_u64s(f, argn, &p->arg_scale) &&
            read_u64s(f, argn, &p->arg_level) &&
            read_u64s(f, resn, &p->res_scale) &&
            read_u64s(f, resn, &p->res_level) &&
            read_u64s(f, resn, &p->res_dst);
  if (ok) {
    p->num_ctxt = body[2];
    p->num_ptxt = body[3];
    p->init_level = body[4];
    p->ops.resize(body[1]);
    ok = body[1] == 0 ||
         std::fread(p->ops.data(), sizeof(Op), body[1], f) == body[1];
  }
  std::fclose(f);
  if (!ok) { delete p; return nullptr; }
  return p;
}

int hevm_save(void* h, const char* path) {
  Program* p = static_cast<Program*>(h);
  FILE* f = std::fopen(path, "wb");
  if (!f) return -1;
  uint32_t magic = kMagic, hdr_size = 24;
  uint64_t argn = p->arg_scale.size(), resn = p->res_scale.size();
  uint64_t body[5] = {40 + 8 * (2 * argn + 3 * resn), p->ops.size(),
                      p->num_ctxt, p->num_ptxt, p->init_level};
  bool ok = std::fwrite(&magic, 4, 1, f) == 1 &&
            std::fwrite(&hdr_size, 4, 1, f) == 1 &&
            std::fwrite(&argn, 8, 1, f) == 1 &&
            std::fwrite(&resn, 8, 1, f) == 1 &&
            std::fwrite(body, 8, 5, f) == 5;
  for (auto* v : {&p->arg_scale, &p->arg_level, &p->res_scale, &p->res_level,
                  &p->res_dst})
    ok = ok && (v->empty() ||
                std::fwrite(v->data(), 8, v->size(), f) == v->size());
  ok = ok && (p->ops.empty() ||
              std::fwrite(p->ops.data(), sizeof(Op), p->ops.size(), f) ==
                  p->ops.size());
  std::fclose(f);
  return ok ? 0 : -1;
}

void* hevm_create(uint64_t argn, uint64_t resn, const uint64_t* arg_scale,
                  const uint64_t* arg_level, const uint64_t* res_scale,
                  const uint64_t* res_level, const uint64_t* res_dst,
                  uint64_t init_level, uint64_t num_ctxt, uint64_t num_ptxt,
                  uint64_t nops, const uint16_t* ops) {
  Program* p = new Program();
  p->init_level = init_level;
  p->num_ctxt = num_ctxt;
  p->num_ptxt = num_ptxt;
  p->arg_scale.assign(arg_scale, arg_scale + argn);
  p->arg_level.assign(arg_level, arg_level + argn);
  p->res_scale.assign(res_scale, res_scale + resn);
  p->res_level.assign(res_level, res_level + resn);
  p->res_dst.assign(res_dst, res_dst + resn);
  p->ops.resize(nops);
  std::memcpy(p->ops.data(), ops, nops * sizeof(Op));
  return p;
}

// out[6] = {argn, resn, nops, num_ctxt, num_ptxt, init_level}
void hevm_meta(void* h, uint64_t* out) {
  Program* p = static_cast<Program*>(h);
  out[0] = p->arg_scale.size();
  out[1] = p->res_scale.size();
  out[2] = p->ops.size();
  out[3] = p->num_ctxt;
  out[4] = p->num_ptxt;
  out[5] = p->init_level;
}

void hevm_copy_arrays(void* h, uint64_t* arg_scale, uint64_t* arg_level,
                      uint64_t* res_scale, uint64_t* res_level,
                      uint64_t* res_dst) {
  Program* p = static_cast<Program*>(h);
  auto cp = [](const std::vector<uint64_t>& v, uint64_t* out) {
    if (!v.empty()) std::memcpy(out, v.data(), 8 * v.size());
  };
  cp(p->arg_scale, arg_scale);
  cp(p->arg_level, arg_level);
  cp(p->res_scale, res_scale);
  cp(p->res_level, res_level);
  cp(p->res_dst, res_dst);
}

void hevm_copy_ops(void* h, uint16_t* out) {
  Program* p = static_cast<Program*>(h);
  if (!p->ops.empty())
    std::memcpy(out, p->ops.data(), p->ops.size() * sizeof(Op));
}

void hevm_free(void* h) { delete static_cast<Program*>(h); }

// Validate the stream: every cipher/plain operand is written before it is
// read, register indices are in bounds, opcodes are known, results are
// produced. Returns -1 if OK, else the index of the first offending op
// (or -2 for a bad result descriptor).
int64_t hevm_validate(void* h) {
  Program* p = static_cast<Program*>(h);
  uint64_t nct = p->num_ctxt, npt = p->num_ptxt;
  std::vector<uint8_t> cdef(nct, 0), pdef(npt, 0);
  for (uint64_t i = 0; i < p->arg_scale.size() && i < nct; ++i) cdef[i] = 1;
  for (uint64_t i = 0; i < p->ops.size(); ++i) {
    const Op& o = p->ops[i];
    switch (o.opcode) {
      case OP_ALLOC:
        continue;
      case OP_ENCODE:
        if (o.dst >= npt) return (int64_t)i;
        pdef[o.dst] = 1;
        continue;
      case OP_ROTATE: case OP_NEGATE: case OP_RESCALE:
      case OP_MODSWITCH: case OP_UPSCALE: case OP_BOOTSTRAP:
        if (o.dst >= nct || o.lhs >= nct || !cdef[o.lhs]) return (int64_t)i;
        cdef[o.dst] = 1;
        continue;
      case OP_ADDCC: case OP_MULCC:
        if (o.dst >= nct || o.lhs >= nct || o.rhs >= nct || !cdef[o.lhs] ||
            !cdef[o.rhs])
          return (int64_t)i;
        cdef[o.dst] = 1;
        continue;
      case OP_ADDCP: case OP_MULCP:
        if (o.dst >= nct || o.lhs >= nct || o.rhs >= npt || !cdef[o.lhs] ||
            !pdef[o.rhs])
          return (int64_t)i;
        cdef[o.dst] = 1;
        continue;
      default:
        return (int64_t)i;
    }
  }
  for (uint64_t r : p->res_dst)
    if (r >= nct || !cdef[r]) return -2;
  return -1;
}

// Liveness-based cipher register compaction over the bytecode (the
// reference's ReuseBuffer, re-done on the artifact). Argument registers are
// pinned; every other cipher register is renamed onto a free-list so dead
// registers are recycled. OP_ALLOC markers are rewritten to match the new
// register count (first-definition order). Returns the new num_ctxt, or -1
// if the program fails validation first.
int64_t hevm_reuse_buffers(void* h) {
  Program* p = static_cast<Program*>(h);
  if (hevm_validate(h) != -1) return -1;
  uint64_t nct = p->num_ctxt;
  uint64_t nargs = p->arg_scale.size();
  const int64_t kEnd = (int64_t)p->ops.size() + 1;

  // last read of each old cipher register (results live to the end)
  std::vector<int64_t> last_use(nct, -1);
  auto is_cipher_rhs = [](uint16_t oc) {
    return oc == OP_ADDCC || oc == OP_MULCC;
  };
  for (uint64_t i = 0; i < p->ops.size(); ++i) {
    const Op& o = p->ops[i];
    if (o.opcode == OP_ALLOC || o.opcode == OP_ENCODE) continue;
    last_use[o.lhs] = (int64_t)i;
    if (is_cipher_rhs(o.opcode)) last_use[o.rhs] = (int64_t)i;
  }
  for (uint64_t r : p->res_dst) last_use[r] = kEnd;
  for (uint64_t i = 0; i < nargs; ++i)
    if (last_use[i] < 0) last_use[i] = 0;  // keep arg slots reserved

  std::vector<Op> out;
  out.reserve(p->ops.size());
  std::vector<int32_t> remap(nct, -1);
  for (uint64_t i = 0; i < nargs; ++i) remap[i] = (int32_t)i;
  std::vector<uint16_t> free_regs;
  uint64_t next_reg = nargs;

  for (uint64_t i = 0; i < p->ops.size(); ++i) {
    Op o = p->ops[i];
    if (o.opcode == OP_ALLOC) continue;  // re-emitted on first definition
    if (o.opcode != OP_ENCODE) {
      uint16_t old_dst = o.dst;
      // rename sources, then release the ones whose last use is here
      o.lhs = (uint16_t)remap[o.lhs];
      uint16_t rhs_old = o.rhs;
      if (is_cipher_rhs(o.opcode)) o.rhs = (uint16_t)remap[rhs_old];
      const Op& orig = p->ops[i];
      if (last_use[orig.lhs] <= (int64_t)i && orig.lhs >= nargs &&
          remap[orig.lhs] >= 0) {
        free_regs.push_back((uint16_t)remap[orig.lhs]);
        remap[orig.lhs] = -1;
      }
      if (is_cipher_rhs(o.opcode) && rhs_old != orig.lhs &&
          last_use[rhs_old] <= (int64_t)i && rhs_old >= nargs &&
          remap[rhs_old] >= 0) {
        free_regs.push_back((uint16_t)remap[rhs_old]);
        remap[rhs_old] = -1;
      }
      // allocate dst (a register may be redefined; reuse its slot if live)
      if (remap[old_dst] < 0 || last_use[old_dst] < (int64_t)i) {
        uint16_t nr;
        if (!free_regs.empty()) {
          nr = free_regs.back();
          free_regs.pop_back();
        } else {
          nr = (uint16_t)next_reg++;
          out.push_back(Op{OP_ALLOC, 0, 0, 0});
        }
        remap[old_dst] = nr;
      }
      o.dst = (uint16_t)remap[old_dst];
    }
    out.push_back(o);
  }
  for (auto& r : p->res_dst) r = (uint64_t)remap[r];
  p->ops.swap(out);
  p->num_ctxt = next_reg;
  return (int64_t)next_reg;
}

// ------------------------------------------------------------------- .cst
void* cst_load(const char* path) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return nullptr;
  Cst* c = new Cst();
  int64_t count = 0;
  bool ok = std::fread(&count, 8, 1, f) == 1 && count >= 0 &&
            count < (1 << 24);
  c->offsets.push_back(0);
  for (int64_t i = 0; ok && i < count; ++i) {
    int64_t len = 0;
    ok = std::fread(&len, 8, 1, f) == 1 && len >= 0 && len < (1 << 28);
    if (!ok) break;
    size_t base = c->data.size();
    c->data.resize(base + (size_t)len);
    ok = len == 0 ||
         std::fread(c->data.data() + base, 8, (size_t)len, f) == (size_t)len;
    c->offsets.push_back(c->data.size());
  }
  std::fclose(f);
  if (!ok) { delete c; return nullptr; }
  return c;
}

uint64_t cst_count(void* h) {
  return static_cast<Cst*>(h)->offsets.size() - 1;
}

uint64_t cst_len(void* h, uint64_t i) {
  Cst* c = static_cast<Cst*>(h);
  return c->offsets[i + 1] - c->offsets[i];
}

void cst_copy(void* h, uint64_t i, double* out) {
  Cst* c = static_cast<Cst*>(h);
  std::memcpy(out, c->data.data() + c->offsets[i],
              8 * (c->offsets[i + 1] - c->offsets[i]));
}

int cst_save(const char* path, uint64_t count, const uint64_t* lens,
             const double* flat) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return -1;
  int64_t cnt = (int64_t)count;
  bool ok = std::fwrite(&cnt, 8, 1, f) == 1;
  const double* cur = flat;
  for (uint64_t i = 0; ok && i < count; ++i) {
    int64_t len = (int64_t)lens[i];
    ok = std::fwrite(&len, 8, 1, f) == 1 &&
         (len == 0 || std::fwrite(cur, 8, (size_t)len, f) == (size_t)len);
    cur += len;
  }
  std::fclose(f);
  return ok ? 0 : -1;
}

void cst_free(void* h) { delete static_cast<Cst*>(h); }

}  // extern "C"
