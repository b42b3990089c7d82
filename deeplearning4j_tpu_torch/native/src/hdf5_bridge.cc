// Minimal HDF5 C bridge over the system libhdf5 (dlopen'd, no headers).
//
// Reference analog: deeplearning4j-modelimport/.../Hdf5Archive.java:25,51-61 —
// native HDF5 reads via JavaCPP for Keras .h5 import (SURVEY.md §2.3 "HDF5
// via JavaCPP" row). This is the C++-over-system-lib equivalent: we declare
// the stable HDF5 1.10 C ABI ourselves (hid_t = int64), resolve symbols with
// dlsym at first use, and expose a small flat C API consumed through ctypes
// by deeplearning4j_tpu_torch.native.h5 (a copy of the JAX package's
// bridge, built into the port's own library).
//
// Supports what Keras files need: groups, float/int scalar datasets
// (contiguous or chunked+deflate — the library handles filters), fixed and
// variable-length string attributes, scalar and 1-D string-array attributes,
// plus enough write support to author spec-compliant fixtures and exports.

#include <dlfcn.h>

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

typedef int64_t hid_t;
typedef int herr_t;
typedef unsigned long long hsize_t;
typedef int htri_t;
typedef long long hssize_t;

// ---- dynamically resolved HDF5 API ----------------------------------------
namespace h5 {

static void* lib = nullptr;

template <typename T>
static T sym(const char* name) {
  return (T)dlsym(lib, name);
}

static herr_t (*open_)();
static hid_t (*fopen_)(const char*, unsigned, hid_t);
static hid_t (*fcreate_)(const char*, unsigned, hid_t, hid_t);
static herr_t (*fclose_)(hid_t);
static hid_t (*gopen_)(hid_t, const char*, hid_t);
static hid_t (*gcreate_)(hid_t, const char*, hid_t, hid_t, hid_t);
static herr_t (*gclose_)(hid_t);
static hid_t (*dopen_)(hid_t, const char*, hid_t);
static hid_t (*dcreate_)(hid_t, const char*, hid_t, hid_t, hid_t, hid_t, hid_t);
static herr_t (*dclose_)(hid_t);
static hid_t (*dget_space_)(hid_t);
static hid_t (*dget_type_)(hid_t);
static herr_t (*dread_)(hid_t, hid_t, hid_t, hid_t, hid_t, void*);
static herr_t (*dwrite_)(hid_t, hid_t, hid_t, hid_t, hid_t, const void*);
static hid_t (*screate_simple_)(int, const hsize_t*, const hsize_t*);
static hid_t (*screate_)(int);
static int (*sget_ndims_)(hid_t);
static int (*sget_dims_)(hid_t, hsize_t*, hsize_t*);
static hssize_t (*sget_npoints_)(hid_t);
static herr_t (*sclose_)(hid_t);
static hid_t (*tcopy_)(hid_t);
static herr_t (*tset_size_)(hid_t, size_t);
static size_t (*tget_size_)(hid_t);
static int (*tget_class_)(hid_t);
static htri_t (*tis_vstr_)(hid_t);
static herr_t (*tclose_)(hid_t);
static hid_t (*acreate_)(hid_t, const char*, hid_t, hid_t, hid_t, hid_t);
static hid_t (*aopen_)(hid_t, const char*, hid_t);
static herr_t (*aread_)(hid_t, hid_t, void*);
static herr_t (*awrite_)(hid_t, hid_t, const void*);
static hid_t (*aget_type_)(hid_t);
static hid_t (*aget_space_)(hid_t);
static herr_t (*aclose_)(hid_t);
static htri_t (*aexists_)(hid_t, const char*);
static htri_t (*lexists_)(hid_t, const char*, hid_t);
static hid_t (*oopen_)(hid_t, const char*, hid_t);
static herr_t (*oclose_)(hid_t);
typedef herr_t (*literate_cb)(hid_t, const char*, const void*, void*);
static herr_t (*literate_)(hid_t, int, int, hsize_t*, literate_cb, void*);
static herr_t (*dvlen_reclaim_)(hid_t, hid_t, hid_t, void*);
static herr_t (*oget_info_by_name_)(hid_t, const char*, void*, hid_t);

static hid_t NATIVE_FLOAT, NATIVE_DOUBLE, NATIVE_INT, NATIVE_LLONG, C_S1;

// H5Oget_info_by_name writes a full H5O_info_t (~160B in 1.10); we pass an
// oversized buffer and read only the prefix: {fileno(ulong), addr(u64),
// type(int at offset 16 on LP64)}. 0 = group, 1 = dataset.
struct OInfoBuf {
  unsigned long fileno;
  uint64_t addr;
  int type;
  char pad[512];  // room for the rest of H5O_info_t
};

static bool init() {
  if (lib) return true;
  const char* names[] = {"libhdf5_serial.so.103", "libhdf5_serial.so",
                         "libhdf5.so.103", "libhdf5.so", nullptr};
  for (int i = 0; names[i]; ++i) {
    lib = dlopen(names[i], RTLD_NOW | RTLD_GLOBAL);
    if (lib) break;
  }
  if (!lib) return false;
  open_ = sym<decltype(open_)>("H5open");
  fopen_ = sym<decltype(fopen_)>("H5Fopen");
  fcreate_ = sym<decltype(fcreate_)>("H5Fcreate");
  fclose_ = sym<decltype(fclose_)>("H5Fclose");
  gopen_ = sym<decltype(gopen_)>("H5Gopen2");
  gcreate_ = sym<decltype(gcreate_)>("H5Gcreate2");
  gclose_ = sym<decltype(gclose_)>("H5Gclose");
  dopen_ = sym<decltype(dopen_)>("H5Dopen2");
  dcreate_ = sym<decltype(dcreate_)>("H5Dcreate2");
  dclose_ = sym<decltype(dclose_)>("H5Dclose");
  dget_space_ = sym<decltype(dget_space_)>("H5Dget_space");
  dget_type_ = sym<decltype(dget_type_)>("H5Dget_type");
  dread_ = sym<decltype(dread_)>("H5Dread");
  dwrite_ = sym<decltype(dwrite_)>("H5Dwrite");
  screate_simple_ = sym<decltype(screate_simple_)>("H5Screate_simple");
  screate_ = sym<decltype(screate_)>("H5Screate");
  sget_ndims_ = sym<decltype(sget_ndims_)>("H5Sget_simple_extent_ndims");
  sget_dims_ = sym<decltype(sget_dims_)>("H5Sget_simple_extent_dims");
  sget_npoints_ = sym<decltype(sget_npoints_)>("H5Sget_simple_extent_npoints");
  sclose_ = sym<decltype(sclose_)>("H5Sclose");
  tcopy_ = sym<decltype(tcopy_)>("H5Tcopy");
  tset_size_ = sym<decltype(tset_size_)>("H5Tset_size");
  tget_size_ = sym<decltype(tget_size_)>("H5Tget_size");
  tget_class_ = sym<decltype(tget_class_)>("H5Tget_class");
  tis_vstr_ = sym<decltype(tis_vstr_)>("H5Tis_variable_str");
  tclose_ = sym<decltype(tclose_)>("H5Tclose");
  acreate_ = sym<decltype(acreate_)>("H5Acreate2");
  aopen_ = sym<decltype(aopen_)>("H5Aopen");
  aread_ = sym<decltype(aread_)>("H5Aread");
  awrite_ = sym<decltype(awrite_)>("H5Awrite");
  aget_type_ = sym<decltype(aget_type_)>("H5Aget_type");
  aget_space_ = sym<decltype(aget_space_)>("H5Aget_space");
  aclose_ = sym<decltype(aclose_)>("H5Aclose");
  aexists_ = sym<decltype(aexists_)>("H5Aexists");
  lexists_ = sym<decltype(lexists_)>("H5Lexists");
  oopen_ = sym<decltype(oopen_)>("H5Oopen");
  oclose_ = sym<decltype(oclose_)>("H5Oclose");
  literate_ = sym<decltype(literate_)>("H5Literate");
  dvlen_reclaim_ = sym<decltype(dvlen_reclaim_)>("H5Dvlen_reclaim");
  oget_info_by_name_ =
      sym<decltype(oget_info_by_name_)>("H5Oget_info_by_name");
  if (!open_ || !fopen_ || !dread_) return false;
  open_();
  // silence HDF5's default error-stack dump to stderr; our flat API returns
  // error codes and the Python layer raises clean exceptions
  auto eset = sym<herr_t (*)(hid_t, void*, void*)>("H5Eset_auto2");
  if (eset) eset(0 /*H5E_DEFAULT*/, nullptr, nullptr);
  NATIVE_FLOAT = *sym<hid_t*>("H5T_NATIVE_FLOAT_g");
  NATIVE_DOUBLE = *sym<hid_t*>("H5T_NATIVE_DOUBLE_g");
  NATIVE_INT = *sym<hid_t*>("H5T_NATIVE_INT_g");
  NATIVE_LLONG = *sym<hid_t*>("H5T_NATIVE_LLONG_g");
  C_S1 = *sym<hid_t*>("H5T_C_S1_g");
  return true;
}

}  // namespace h5

static const hid_t H5P_DEFAULT = 0;
static const unsigned H5F_ACC_RDONLY = 0u;
static const unsigned H5F_ACC_TRUNC = 2u;
enum { H5T_INTEGER = 0, H5T_FLOAT = 1, H5T_STRING = 3 };
enum { H5_INDEX_NAME = 0, H5_ITER_INC = 0 };

// Create intermediate groups for "a/b/c" style paths; returns hid of the
// parent group that should hold the final component (caller closes if != file).
static hid_t ensure_parent_groups(hid_t file, const std::string& path,
                                  std::string* leaf) {
  size_t pos = 0, next;
  hid_t cur = file;
  std::string rest = path;
  while ((next = rest.find('/')) != std::string::npos) {
    std::string part = rest.substr(0, next);
    rest = rest.substr(next + 1);
    if (part.empty()) continue;
    hid_t child;
    if (h5::lexists_(cur, part.c_str(), H5P_DEFAULT) > 0) {
      child = h5::gopen_(cur, part.c_str(), H5P_DEFAULT);
    } else {
      child = h5::gcreate_(cur, part.c_str(), H5P_DEFAULT, H5P_DEFAULT,
                           H5P_DEFAULT);
    }
    if (cur != file) h5::gclose_(cur);
    if (child < 0) return -1;
    cur = child;
  }
  *leaf = rest;
  (void)pos;
  return cur;
}

extern "C" {

int dl4j_h5_available() { return h5::init() ? 1 : 0; }

// mode 0 = read-only, 1 = create/truncate
hid_t dl4j_h5_open(const char* path, int mode) {
  if (!h5::init()) return -1;
  if (mode == 0) return h5::fopen_(path, H5F_ACC_RDONLY, H5P_DEFAULT);
  return h5::fcreate_(path, H5F_ACC_TRUNC, H5P_DEFAULT, H5P_DEFAULT);
}

int dl4j_h5_close(hid_t file) { return (int)h5::fclose_(file); }

int dl4j_h5_exists(hid_t file, const char* path) {
  // check every prefix — H5Lexists on a deep path errors if a prefix is absent
  std::string p(path), prefix;
  size_t start = 0;
  while (start < p.size()) {
    size_t slash = p.find('/', start);
    if (slash == std::string::npos) slash = p.size();
    if (slash > start) {
      prefix = p.substr(0, slash);
      if (h5::lexists_(file, prefix.c_str(), H5P_DEFAULT) <= 0) return 0;
    }
    start = slash + 1;
  }
  return 1;
}

struct ListCtx {
  std::string out;
  hid_t loc;
  std::string base;
};

static herr_t list_cb(hid_t loc, const char* name, const void*, void* op) {
  ListCtx* ctx = (ListCtx*)op;
  h5::OInfoBuf info{};
  std::string full = ctx->base.empty() ? name : ctx->base + "/" + name;
  char kind = '?';
  if (h5::oget_info_by_name_ &&
      h5::oget_info_by_name_(ctx->loc, full.c_str(), &info, H5P_DEFAULT) >= 0) {
    kind = info.type == 0 ? 'g' : info.type == 1 ? 'd' : '?';
  }
  if (kind == '?') {
    // ABI-proof fallback (H5Oget_info_by_name is versioned differently in
    // hdf5 >= 1.12): probe by opening as dataset, then as group
    hid_t probe = h5::dopen_(ctx->loc, full.c_str(), H5P_DEFAULT);
    if (probe >= 0) {
      kind = 'd';
      h5::dclose_(probe);
    } else {
      probe = h5::gopen_(ctx->loc, full.c_str(), H5P_DEFAULT);
      if (probe >= 0) {
        kind = 'g';
        h5::gclose_(probe);
      }
    }
  }
  ctx->out += kind;
  ctx->out += ' ';
  ctx->out += name;
  ctx->out += '\n';
  return 0;
}

// List children of a group as "g name\n" / "d name\n" lines. Returns number
// of children, or -1 on error; -2 if the buffer is too small (required size
// written to *needed).
int64_t dl4j_h5_list(hid_t file, const char* path, char* out, int64_t cap,
                     int64_t* needed) {
  if (!h5::init()) return -1;
  ListCtx ctx;
  ctx.loc = file;
  ctx.base = (std::strcmp(path, "/") == 0 || path[0] == 0) ? "" : path;
  hid_t grp = h5::gopen_(file, path[0] ? path : "/", H5P_DEFAULT);
  if (grp < 0) return -1;
  hsize_t idx = 0;
  herr_t r = h5::literate_(grp, H5_INDEX_NAME, H5_ITER_INC, &idx, list_cb,
                           &ctx);
  h5::gclose_(grp);
  if (r < 0) return -1;
  int64_t count = 0;
  for (char c : ctx.out)
    if (c == '\n') ++count;
  *needed = (int64_t)ctx.out.size() + 1;
  if ((int64_t)ctx.out.size() + 1 > cap) return -2;
  std::memcpy(out, ctx.out.c_str(), ctx.out.size() + 1);
  return count;
}

// Dataset metadata: ndim, dims[8], type class (0 int, 1 float, 3 string),
// element size in bytes. Returns 0 on success.
int dl4j_h5_dataset_info(hid_t file, const char* path, int* ndim,
                         int64_t* dims, int* type_class, int* elem_size) {
  if (!h5::init()) return -1;
  hid_t ds = h5::dopen_(file, path, H5P_DEFAULT);
  if (ds < 0) return -1;
  hid_t sp = h5::dget_space_(ds);
  hid_t ty = h5::dget_type_(ds);
  int nd = h5::sget_ndims_(sp);
  if (nd > 8) {  // out-param holds 8 dims; refuse higher ranks cleanly
    h5::tclose_(ty);
    h5::sclose_(sp);
    h5::dclose_(ds);
    return -4;
  }
  hsize_t hdims[8] = {0};
  h5::sget_dims_(sp, hdims, nullptr);
  for (int i = 0; i < nd; ++i) dims[i] = (int64_t)hdims[i];
  *ndim = nd;
  *type_class = h5::tget_class_(ty);
  *elem_size = (int)h5::tget_size_(ty);
  h5::tclose_(ty);
  h5::sclose_(sp);
  h5::dclose_(ds);
  return 0;
}

// Read a numeric dataset converted to float32. `n` must equal the element
// count. Returns 0 on success.
int dl4j_h5_read_f32(hid_t file, const char* path, float* out, int64_t n) {
  if (!h5::init()) return -1;
  hid_t ds = h5::dopen_(file, path, H5P_DEFAULT);
  if (ds < 0) return -1;
  hid_t sp = h5::dget_space_(ds);
  hssize_t npts = h5::sget_npoints_(sp);
  h5::sclose_(sp);
  if (npts != n) {
    h5::dclose_(ds);
    return -3;
  }
  herr_t r = h5::dread_(ds, h5::NATIVE_FLOAT, 0, 0, H5P_DEFAULT, out);
  h5::dclose_(ds);
  return r < 0 ? -2 : 0;
}

int dl4j_h5_read_i64(hid_t file, const char* path, int64_t* out, int64_t n) {
  if (!h5::init()) return -1;
  hid_t ds = h5::dopen_(file, path, H5P_DEFAULT);
  if (ds < 0) return -1;
  herr_t r = h5::dread_(ds, h5::NATIVE_LLONG, 0, 0, H5P_DEFAULT, out);
  h5::dclose_(ds);
  return r < 0 ? -2 : 0;
}

// Write a float32 dataset, creating intermediate groups. Returns 0 on success.
int dl4j_h5_write_f32(hid_t file, const char* path, const float* data,
                      const int64_t* dims, int ndim) {
  if (!h5::init()) return -1;
  if (ndim < 0 || ndim > 8) return -4;
  std::string leaf;
  hid_t parent = ensure_parent_groups(file, path, &leaf);
  if (parent < 0) return -1;
  hsize_t hdims[8];
  for (int i = 0; i < ndim; ++i) hdims[i] = (hsize_t)dims[i];
  hid_t sp = h5::screate_simple_(ndim, hdims, nullptr);
  hid_t ds = h5::dcreate_(parent, leaf.c_str(), h5::NATIVE_FLOAT, sp,
                          H5P_DEFAULT, H5P_DEFAULT, H5P_DEFAULT);
  herr_t r = -1;
  if (ds >= 0) {
    r = h5::dwrite_(ds, h5::NATIVE_FLOAT, 0, 0, H5P_DEFAULT, data);
    h5::dclose_(ds);
  }
  h5::sclose_(sp);
  if (parent != file) h5::gclose_(parent);
  return r < 0 ? -2 : 0;
}

// Create an (empty) group chain.
int dl4j_h5_make_group(hid_t file, const char* path) {
  if (!h5::init()) return -1;
  std::string leaf;
  std::string full = std::string(path) + "/";
  hid_t parent = ensure_parent_groups(file, full, &leaf);
  if (parent < 0) return -1;
  if (parent != file) h5::gclose_(parent);
  return 0;
}

// ---- attributes ------------------------------------------------------------

// Read a string attribute (scalar, fixed or variable length). Returns length
// or -1; -2 if cap too small.
int64_t dl4j_h5_read_attr_str(hid_t file, const char* obj_path,
                              const char* name, char* out, int64_t cap) {
  if (!h5::init()) return -1;
  hid_t obj = h5::oopen_(file, obj_path[0] ? obj_path : "/", H5P_DEFAULT);
  if (obj < 0) return -1;
  if (h5::aexists_(obj, name) <= 0) {
    h5::oclose_(obj);
    return -1;
  }
  hid_t at = h5::aopen_(obj, name, H5P_DEFAULT);
  hid_t ty = h5::aget_type_(at);
  int64_t len = -1;
  if (h5::tis_vstr_(ty) > 0) {
    char* p = nullptr;
    hid_t mt = h5::tcopy_(h5::C_S1);
    h5::tset_size_((hid_t)mt, (size_t)-1);  // H5T_VARIABLE
    if (h5::aread_(at, mt, &p) >= 0 && p) {
      len = (int64_t)std::strlen(p);
      if (len + 1 <= cap)
        std::memcpy(out, p, (size_t)len + 1);
      else
        len = -2;
      free(p);
    }
    h5::tclose_(mt);
  } else {
    size_t sz = h5::tget_size_(ty);
    // memory type one byte LARGER than the file type: a null-PADDED file
    // string of exactly sz chars (h5py's fixed-length layout) converted
    // into a null-TERMINATED memory string of the same size would have
    // its final character truncated to make room for the terminator
    std::vector<char> buf(sz + 2, 0);
    hid_t mt = h5::tcopy_(h5::C_S1);
    h5::tset_size_(mt, sz + 1);
    if (h5::aread_(at, mt, buf.data()) >= 0) {
      len = (int64_t)strnlen(buf.data(), sz + 1);
      if (len + 1 <= cap) {
        std::memcpy(out, buf.data(), (size_t)len);
        out[len] = 0;
      } else {
        len = -2;
      }
    }
    h5::tclose_(mt);
  }
  h5::tclose_(ty);
  h5::aclose_(at);
  h5::oclose_(obj);
  return len;
}

// Read a 1-D string-array attribute as newline-joined names. Returns count,
// -1 on error, -2 if cap too small (needed size in *needed).
int64_t dl4j_h5_read_attr_strs(hid_t file, const char* obj_path,
                               const char* name, char* out, int64_t cap,
                               int64_t* needed) {
  if (!h5::init()) return -1;
  hid_t obj = h5::oopen_(file, obj_path[0] ? obj_path : "/", H5P_DEFAULT);
  if (obj < 0) return -1;
  if (h5::aexists_(obj, name) <= 0) {
    h5::oclose_(obj);
    return -1;
  }
  hid_t at = h5::aopen_(obj, name, H5P_DEFAULT);
  hid_t ty = h5::aget_type_(at);
  hid_t sp = h5::aget_space_(at);
  hssize_t n = h5::sget_npoints_(sp);
  std::string joined;
  int64_t count = -1;
  if (h5::tis_vstr_(ty) > 0) {
    std::vector<char*> ptrs((size_t)n, nullptr);
    hid_t mt = h5::tcopy_(h5::C_S1);
    h5::tset_size_(mt, (size_t)-1);
    if (h5::aread_(at, mt, ptrs.data()) >= 0) {
      count = n;
      for (hssize_t i = 0; i < n; ++i) {
        if (ptrs[i]) joined += ptrs[i];
        joined += '\n';
        free(ptrs[i]);
      }
    }
    h5::tclose_(mt);
  } else {
    size_t sz = h5::tget_size_(ty);
    // sz+1 memory stride for the same null-padded-vs-terminated reason
    // as dl4j_h5_read_attr_str: equal-size conversion truncates the
    // final character of exact-length fixed strings (found by the
    // reference's genuine tfscope/model.h5 fixture: 'dense_1_W:0' came
    // back as 'dense_1_W:')
    std::vector<char> buf((size_t)n * (sz + 1), 0);
    hid_t mt = h5::tcopy_(h5::C_S1);
    h5::tset_size_(mt, sz + 1);
    if (h5::aread_(at, mt, buf.data()) >= 0) {
      count = n;
      for (hssize_t i = 0; i < n; ++i) {
        const char* s = buf.data() + (size_t)i * (sz + 1);
        joined.append(s, strnlen(s, sz + 1));
        joined += '\n';
      }
    }
    h5::tclose_(mt);
  }
  h5::sclose_(sp);
  h5::tclose_(ty);
  h5::aclose_(at);
  h5::oclose_(obj);
  if (count < 0) return -1;
  *needed = (int64_t)joined.size() + 1;
  if ((int64_t)joined.size() + 1 > cap) return -2;
  std::memcpy(out, joined.c_str(), joined.size() + 1);
  return count;
}

// Write a scalar fixed-length string attribute.
int dl4j_h5_write_attr_str(hid_t file, const char* obj_path, const char* name,
                           const char* value) {
  if (!h5::init()) return -1;
  hid_t obj = h5::oopen_(file, obj_path[0] ? obj_path : "/", H5P_DEFAULT);
  if (obj < 0) return -1;
  size_t len = std::strlen(value);
  hid_t ty = h5::tcopy_(h5::C_S1);
  h5::tset_size_(ty, len ? len : 1);
  hid_t sp = h5::screate_(0 /*H5S_SCALAR*/);
  hid_t at = h5::acreate_(obj, name, ty, sp, H5P_DEFAULT, H5P_DEFAULT);
  herr_t r = -1;
  if (at >= 0) {
    r = h5::awrite_(at, ty, value);
    h5::aclose_(at);
  }
  h5::sclose_(sp);
  h5::tclose_(ty);
  h5::oclose_(obj);
  return r < 0 ? -2 : 0;
}

// Write a 1-D fixed-length string-array attribute from newline-joined values
// (the h5py/Keras "layer_names" convention uses fixed-length byte strings).
int dl4j_h5_write_attr_strs(hid_t file, const char* obj_path, const char* name,
                            const char* joined) {
  if (!h5::init()) return -1;
  std::vector<std::string> items;
  const char* p = joined;
  while (*p) {
    const char* nl = std::strchr(p, '\n');
    if (!nl) {
      items.emplace_back(p);
      break;
    }
    items.emplace_back(p, nl - p);
    p = nl + 1;
  }
  size_t maxlen = 1;
  for (auto& s : items) maxlen = s.size() > maxlen ? s.size() : maxlen;
  std::vector<char> buf(items.size() * maxlen + 1, 0);  // +1: non-null ptr for n=0
  for (size_t i = 0; i < items.size(); ++i)
    std::memcpy(buf.data() + i * maxlen, items[i].data(), items[i].size());
  hid_t obj = h5::oopen_(file, obj_path[0] ? obj_path : "/", H5P_DEFAULT);
  if (obj < 0) return -1;
  hid_t ty = h5::tcopy_(h5::C_S1);
  h5::tset_size_(ty, maxlen);
  hsize_t n = items.size();
  hid_t sp = h5::screate_simple_(1, &n, nullptr);
  hid_t at = h5::acreate_(obj, name, ty, sp, H5P_DEFAULT, H5P_DEFAULT);
  herr_t r = -1;
  if (at >= 0) {
    // zero-length arrays: create the attribute but skip the (empty) write
    r = n == 0 ? 0 : h5::awrite_(at, ty, buf.data());
    h5::aclose_(at);
  }
  h5::sclose_(sp);
  h5::tclose_(ty);
  h5::oclose_(obj);
  return r < 0 ? -2 : 0;
}

}  // extern "C"
