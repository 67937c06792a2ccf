// Native JBinaryData (.bi4) codec — the hot host-side I/O path.
//
// The reference implements its particle-data container in C++
// (JBinaryData.cpp, 2,774 LoC); this is the framework's native
// equivalent for the PART write path: assembling multi-megabyte snapshot
// files in Python costs noticeable host time at scale, so the byte-level
// serialization runs here and Python (io/jbinary.py) stays the reference
// implementation + reader.
//
// Format (see io/jbinary.py docstring): 64-byte "#FileJBD" head, item tree
// with typed values and raw arrays, little-endian.
//
// C API (ctypes-friendly):
//   jb_writer_new(filecode) -> handle      ; root item == filecode name
//   jb_item_child(h, parent, name) -> id   ; parent 0 = root
//   jb_set_*(h, item, name, value...)
//   jb_add_array(h, item, name, type, count, comps, data_ptr)
//   jb_write(h, path) -> 0/err
//   jb_free(h)
//
// Build: g++ -O2 -shared -fPIC jbinary_native.cpp -o libjbnative.so

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>
#include <memory>

namespace {

enum TpData : int32_t {
  DatText = 1, DatBool = 2, DatChar = 3, DatUchar = 4, DatShort = 5,
  DatUshort = 6, DatInt = 7, DatUint = 8, DatLlong = 9, DatUllong = 10,
  DatFloat = 11, DatDouble = 12,
  DatInt3 = 20, DatUint3 = 21, DatFloat3 = 22, DatDouble3 = 23,
};

size_t type_size(int32_t t) {
  switch (t) {
    case DatBool: case DatInt: case DatUint: case DatFloat: return 4;
    case DatChar: case DatUchar: return 1;
    case DatShort: case DatUshort: return 2;
    case DatLlong: case DatUllong: case DatDouble: return 8;
    case DatInt3: case DatUint3: case DatFloat3: return 12;
    case DatDouble3: return 24;
    default: return 0;
  }
}

struct Buf {
  std::vector<uint8_t> d;
  void raw(const void* p, size_t n) {
    const uint8_t* b = static_cast<const uint8_t*>(p);
    d.insert(d.end(), b, b + n);
  }
  template <typename T> void put(T v) { raw(&v, sizeof(T)); }
  void str(const std::string& s) {
    put<uint32_t>(static_cast<uint32_t>(s.size()));
    raw(s.data(), s.size());
  }
};

struct Value {
  std::string name;
  int32_t type;
  std::string text;
  double num[3] = {0, 0, 0};
  int64_t inum[3] = {0, 0, 0};
};

struct Array {
  std::string name;
  int32_t type;
  uint32_t count;
  std::vector<uint8_t> data;
};

struct Item {
  std::string name;
  std::vector<Value> values;
  std::vector<Array> arrays;
  std::vector<std::unique_ptr<Item>> items;
};

void emit_value(Buf& b, const Value& v) {
  b.str(v.name);
  b.put<int32_t>(v.type);
  switch (v.type) {
    case DatText: b.str(v.text); break;
    case DatBool: case DatInt: b.put<int32_t>((int32_t)v.inum[0]); break;
    case DatUint: b.put<uint32_t>((uint32_t)v.inum[0]); break;
    case DatLlong: b.put<int64_t>(v.inum[0]); break;
    case DatUllong: b.put<uint64_t>((uint64_t)v.inum[0]); break;
    case DatFloat: b.put<float>((float)v.num[0]); break;
    case DatDouble: b.put<double>(v.num[0]); break;
    case DatUint3:
      for (int i = 0; i < 3; i++) b.put<uint32_t>((uint32_t)v.inum[i]);
      break;
    case DatInt3:
      for (int i = 0; i < 3; i++) b.put<int32_t>((int32_t)v.inum[i]);
      break;
    case DatFloat3:
      for (int i = 0; i < 3; i++) b.put<float>((float)v.num[i]);
      break;
    case DatDouble3:
      for (int i = 0; i < 3; i++) b.put<double>(v.num[i]);
      break;
  }
}

void emit_item(Buf& out, const Item& it) {
  // values blob
  Buf vals;
  vals.str("\nVALUES");
  vals.put<uint32_t>((uint32_t)it.values.size());
  for (const auto& v : it.values) emit_value(vals, v);
  // item base
  Buf base;
  base.str("\nITEM\n");
  base.str(it.name);
  base.put<int32_t>(0);  // hide
  base.put<int32_t>(0);  // hidevalues
  base.str("%15.7E");
  base.str("%20.12E");
  base.put<uint32_t>((uint32_t)it.arrays.size());
  base.put<uint32_t>((uint32_t)it.items.size());
  base.put<uint32_t>((uint32_t)vals.d.size());
  out.put<uint32_t>((uint32_t)base.d.size());
  out.raw(base.d.data(), base.d.size());
  out.raw(vals.d.data(), vals.d.size());
  for (const auto& ar : it.arrays) {
    Buf ab;
    ab.str("\nARRAY");
    ab.str(ar.name);
    ab.put<int32_t>(0);  // hide
    ab.put<int32_t>(ar.type);
    ab.put<uint32_t>(ar.count);
    ab.put<uint32_t>((uint32_t)ar.data.size());
    out.put<uint32_t>((uint32_t)ab.d.size());
    out.raw(ab.d.data(), ab.d.size());
    out.raw(ar.data.data(), ar.data.size());
  }
  for (const auto& sub : it.items) emit_item(out, *sub);
}

struct Writer {
  std::string filecode;
  Item root;
  std::vector<Item*> byid;   // id 0 = root
};

Item* item_of(Writer* w, int id) {
  if (id < 0 || (size_t)id >= w->byid.size()) return nullptr;
  return w->byid[id];
}

}  // namespace

extern "C" {

void* jb_writer_new(const char* filecode) {
  Writer* w = new Writer();
  w->filecode = filecode;
  w->root.name = filecode;
  w->byid.push_back(&w->root);
  return w;
}

int jb_item_child(void* h, int parent, const char* name) {
  Writer* w = static_cast<Writer*>(h);
  Item* p = item_of(w, parent);
  if (!p) return -1;
  p->items.emplace_back(new Item());
  Item* it = p->items.back().get();
  it->name = name;
  w->byid.push_back(it);
  return (int)w->byid.size() - 1;
}

static Value* addv(void* h, int item, const char* name, int32_t type) {
  Writer* w = static_cast<Writer*>(h);
  Item* it = item_of(w, item);
  if (!it) return nullptr;
  it->values.push_back(Value());
  Value* v = &it->values.back();
  v->name = name;
  v->type = type;
  return v;
}

int jb_set_text(void* h, int item, const char* name, const char* val) {
  Value* v = addv(h, item, name, DatText);
  if (!v) return 1;
  v->text = val;
  return 0;
}

int jb_set_num(void* h, int item, const char* name, int type, double a,
               double b, double c) {
  Value* v = addv(h, item, name, (int32_t)type);
  if (!v) return 1;
  v->num[0] = a; v->num[1] = b; v->num[2] = c;
  return 0;
}

int jb_set_int(void* h, int item, const char* name, int type, long long a,
               long long b, long long c) {
  Value* v = addv(h, item, name, (int32_t)type);
  if (!v) return 1;
  v->inum[0] = a; v->inum[1] = b; v->inum[2] = c;
  return 0;
}

int jb_add_array(void* h, int item, const char* name, int type,
                 unsigned count, const void* data) {
  Writer* w = static_cast<Writer*>(h);
  Item* it = item_of(w, item);
  if (!it) return 1;
  size_t nbytes = type_size(type) * (size_t)count;
  it->arrays.push_back(Array());
  Array& ar = it->arrays.back();
  ar.name = name;
  ar.type = type;
  ar.count = count;
  ar.data.assign(static_cast<const uint8_t*>(data),
                 static_cast<const uint8_t*>(data) + nbytes);
  return 0;
}

int jb_write(void* h, const char* path) {
  Writer* w = static_cast<Writer*>(h);
  Buf out;
  // 64-byte head
  std::string titu = "#FileJBD " + w->filecode;
  titu.resize(58, ' ');
  titu += "\n";
  char head[64];
  memset(head, 0, sizeof(head));
  memcpy(head, titu.data(), 59);
  out.raw(head, 64);
  emit_item(out, w->root);
  FILE* f = fopen(path, "wb");
  if (!f) return 1;
  size_t n = fwrite(out.d.data(), 1, out.d.size(), f);
  fclose(f);
  return n == out.d.size() ? 0 : 2;
}

void jb_free(void* h) { delete static_cast<Writer*>(h); }

}  // extern "C"
