// Standalone C++ predict client over the PyTorch port (the counterpart of
// src/predict_client.cc): load a Predictor.export blob through the MXPred*
// C ABI (predict_api.cc), read a batch of raw float32 records through the
// RecordIO C ABI (src/recordio.cc), run one forward, and print the argmax
// of every output row.  No Python is written by the consumer.
//
// Usage: predict_client [--dev-type T] [--dev-id I] [--zeros NAME DIMS]...
//                       <artifact> <recfile> <nrecords> <dim...>
//   records hold raw little-endian float32 payloads of prod(dim) elements;
//   the artifact's first input is named "data" with shape
//   (nrecords, dim...).  --dev-type 1 (the CPU, the default) or 2 (the
//   card --dev-id).  --zeros feeds a further input NAME of zeros with
//   shape DIMS ("8x2048"), declared after "data" in that order (the LM's
//   softmax_label, which its forward does not read).
//
// Build (mxnet_tpu_torch/_native.py's predict_client() does this):
//   g++ -O2 -std=c++17 predict_client.cc predict_api.cc recordio.cc \
//       $(python3-config --embed --cflags --ldflags) -o predict_client

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

extern "C" {
const char *MXGetLastError();
int MXPredCreate(const char *, uint64_t, int, int, uint32_t, const char **,
                 const uint32_t *, const uint32_t *, void **);
int MXPredSetInput(void *, const char *, const float *, uint32_t,
                   const uint32_t *, uint32_t);
int MXPredForward(void *);
int MXPredGetOutputShape(void *, uint32_t, uint32_t **, uint32_t *);
int MXPredGetOutput(void *, uint32_t, float *, uint32_t);
int MXPredFree(void *);

const char *rio_last_error();
void *rio_reader_open(const char *);
int rio_reader_next(void *, const void **, uint64_t *);
int rio_reader_close(void *);
}

namespace {

int die(const char *what, const char *detail) {
  std::fprintf(stderr, "predict_client: %s: %s\n", what, detail);
  return 1;
}

struct Input {
  std::string name;
  std::vector<uint32_t> shape;
  std::vector<float> values;
};

std::vector<uint32_t> parse_dims(const char *s) {
  std::vector<uint32_t> dims;
  const char *p = s;
  while (*p) {
    dims.push_back(static_cast<uint32_t>(std::strtoul(p, nullptr, 10)));
    p = std::strchr(p, 'x');
    if (!p) break;
    ++p;
  }
  return dims;
}

}  // namespace

int main(int argc, char **argv) {
  int dev_type = 1, dev_id = 0;
  std::vector<Input> extra;
  int i = 1;
  for (; i < argc && std::strncmp(argv[i], "--", 2) == 0; ++i) {
    std::string opt = argv[i];
    if (opt == "--dev-type" && i + 1 < argc) {
      dev_type = std::atoi(argv[++i]);
    } else if (opt == "--dev-id" && i + 1 < argc) {
      dev_id = std::atoi(argv[++i]);
    } else if (opt == "--zeros" && i + 2 < argc) {
      Input in;
      in.name = argv[++i];
      in.shape = parse_dims(argv[++i]);
      uint64_t n = 1;
      for (uint32_t d : in.shape) n *= d;
      in.values.assign(n, 0.0f);
      extra.push_back(in);
    } else {
      return die("unknown option", argv[i]);
    }
  }
  if (argc - i < 3) {
    std::fprintf(stderr,
                 "usage: %s [--dev-type T] [--dev-id I] [--zeros NAME DIMS]"
                 " <artifact> <recfile> <nrecords> <dim...>\n", argv[0]);
    return 2;
  }
  const char *artifact_path = argv[i];
  const char *rec_path = argv[i + 1];
  uint32_t nrec = static_cast<uint32_t>(std::atoi(argv[i + 2]));
  Input data;
  data.name = "data";
  data.shape.push_back(nrec);
  uint64_t per_rec = 1;
  for (int j = i + 3; j < argc; ++j) {
    data.shape.push_back(static_cast<uint32_t>(std::atoi(argv[j])));
    per_rec *= data.shape.back();
  }

  // ---- artifact bytes
  std::FILE *f = std::fopen(artifact_path, "rb");
  if (!f) return die("open artifact", artifact_path);
  std::fseek(f, 0, SEEK_END);
  long len = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::vector<char> blob(len);
  if (std::fread(blob.data(), 1, len, f) != static_cast<size_t>(len)) {
    std::fclose(f);
    return die("read artifact", artifact_path);
  }
  std::fclose(f);

  // ---- batch from recordio (raw float32 payloads)
  void *reader = rio_reader_open(rec_path);
  if (!reader) return die("open recordio", rio_last_error());
  data.values.resize(static_cast<size_t>(nrec) * per_rec);
  for (uint32_t r = 0; r < nrec; ++r) {
    const void *payload = nullptr;
    uint64_t dlen = 0;
    if (rio_reader_next(reader, &payload, &dlen) != 1) {
      return die("read record", rio_last_error());
    }
    if (dlen != per_rec * 4) {
      std::fprintf(stderr, "record %u: %llu bytes, want %llu\n", r,
                   (unsigned long long)dlen,
                   (unsigned long long)(per_rec * 4));
      return 1;
    }
    std::memcpy(data.values.data() + static_cast<size_t>(r) * per_rec,
                payload, dlen);
  }
  rio_reader_close(reader);

  // ---- predict through the C ABI
  std::vector<Input> inputs;
  inputs.push_back(data);
  inputs.insert(inputs.end(), extra.begin(), extra.end());
  std::vector<const char *> keys;
  std::vector<uint32_t> indptr{0}, shapes;
  for (const Input &in : inputs) {
    keys.push_back(in.name.c_str());
    shapes.insert(shapes.end(), in.shape.begin(), in.shape.end());
    indptr.push_back(static_cast<uint32_t>(shapes.size()));
  }
  void *h = nullptr;
  if (MXPredCreate(blob.data(), blob.size(), dev_type, dev_id,
                   static_cast<uint32_t>(inputs.size()), keys.data(),
                   indptr.data(), shapes.data(), &h) != 0) {
    return die("MXPredCreate", MXGetLastError());
  }
  for (const Input &in : inputs) {
    if (MXPredSetInput(h, in.name.c_str(), in.values.data(),
                       static_cast<uint32_t>(in.values.size()),
                       in.shape.data(),
                       static_cast<uint32_t>(in.shape.size())) != 0) {
      return die("MXPredSetInput", MXGetLastError());
    }
  }
  if (MXPredForward(h) != 0) return die("MXPredForward", MXGetLastError());

  uint32_t *oshape = nullptr;
  uint32_t ondim = 0;
  if (MXPredGetOutputShape(h, 0, &oshape, &ondim) != 0) {
    return die("MXPredGetOutputShape", MXGetLastError());
  }
  uint64_t osize = 1;
  for (uint32_t d = 0; d < ondim; ++d) osize *= oshape[d];
  uint64_t rows = (ondim >= 1) ? oshape[0] : 1;
  std::vector<float> out(osize);
  if (MXPredGetOutput(h, 0, out.data(),
                      static_cast<uint32_t>(osize)) != 0) {
    return die("MXPredGetOutput", MXGetLastError());
  }

  uint64_t classes = (ondim >= 2) ? osize / rows : 1;
  for (uint64_t r = 0; r < rows; ++r) {
    const float *row = out.data() + static_cast<size_t>(r) * classes;
    uint64_t best = 0;
    for (uint64_t c = 1; c < classes; ++c) {
      if (row[c] > row[best]) best = c;
    }
    std::printf("record %llu: class %llu prob %.4f\n",
                (unsigned long long)r, (unsigned long long)best, row[best]);
  }
  MXPredFree(h);
  return 0;
}
