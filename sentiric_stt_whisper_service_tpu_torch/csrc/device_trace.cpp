// A device trace of the card's kernels, on CUPTI's activity API, written as
// a Chrome trace: the recorder behind the port's /debug/profile on the card
// (serving/device_trace.py builds and binds it).
//
// It replaces no TPU kernel. The JAX package's /debug/profile records a
// jax.profiler trace beside running requests. torch.profiler's kineto
// records the same kernels but builds its results inside its stop, at
// about 50 us a record and holding the interpreter lock, and its stop
// deadlocked beside a graph replay in another thread; so the port's route
// held the engine's device lock around it, and a 1 s trace beside a beam
// decode (every node of every CUDA graph replay is a record) held the
// service for tens of seconds. Here:
//   * CUPTI_ACTIVITY_KIND_CONCURRENT_KERNEL gives one record per kernel,
//     eager or a graph's node (CUPTI's graph-level tracing, one record per
//     graph launch, crashed launches of graphs instantiated while it was
//     off: chip_profile.py --cupti-probe);
//   * the buffer callback copies each record's few fields into a vector
//     (kernel names interned once, at most kMaxRecords kept), so a flush
//     costs well under a microsecond a record;
//   * sstw_trace_write renders the Chrome JSON (demangled names, escaped
//     once each) from the vector after the stop, with no CUPTI state held;
//   * everything runs outside the Python interpreter lock (ctypes releases
//     it around each call); only graph launches wait, for the start and
//     the stop (CUPTI's calls deadlock beside a graph launch in another
//     thread: the caller holds models.graphs.GRAPH_LAUNCHES around them).
// Bound: host work per record, and CUPTI's own timestamps around each
// kernel while the kind is enabled (about a microsecond a graph node on
// the card).
//
// C interface (0 or a CUptiResult unless noted):
//   sstw_trace_start()      register the buffer callbacks, enable the kind
//   sstw_trace_stop()       disable the kind, flush every buffer
//   sstw_trace_counts(out)  out[4]: kernels kept, other records, records
//                           dropped (by CUPTI or past kMaxRecords), buffers
//   sstw_trace_write(path)  the Chrome trace of the last start..stop: the
//                           number of events written, or -1 on an I/O error
//   sstw_trace_error(code)  CUPTI's text for a result (const char*)

#include <cupti.h>
#include <cxxabi.h>

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <mutex>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

constexpr size_t kBufferBytes = 8u << 20;
constexpr size_t kMaxRecords = 2u << 20;  // 48 bytes each

struct Record {
  uint64_t start, end;
  uint32_t device, stream, correlation;
  int32_t name;  // index into g_names
  int32_t grid[3], block[3];
};

std::mutex g_mu;
std::vector<Record> g_records;
std::vector<std::string> g_names;
std::unordered_map<const char*, int32_t> g_name_index;  // CUPTI's shared name pointers
uint64_t g_other = 0, g_dropped = 0, g_buffers = 0;
bool g_recording = false;  // records that arrive outside a trace are discarded

int32_t intern(const char* name) {
  if (name == nullptr) name = "?";
  auto it = g_name_index.find(name);
  if (it != g_name_index.end()) return it->second;
  int32_t id = static_cast<int32_t>(g_names.size());
  g_names.emplace_back(name);
  g_name_index.emplace(name, id);
  return id;
}

void CUPTIAPI buffer_requested(uint8_t** buffer, size_t* size, size_t* max_records) {
  *buffer = static_cast<uint8_t*>(aligned_alloc(8, kBufferBytes));
  *size = *buffer != nullptr ? kBufferBytes : 0;
  *max_records = 0;  // as many as fit
}

void CUPTIAPI buffer_completed(CUcontext ctx, uint32_t stream_id, uint8_t* buffer, size_t,
                               size_t valid) {
  std::lock_guard<std::mutex> lock(g_mu);
  CUpti_Activity* rec = nullptr;
  while (g_recording && cuptiActivityGetNextRecord(buffer, valid, &rec) == CUPTI_SUCCESS) {
    if (rec->kind != CUPTI_ACTIVITY_KIND_CONCURRENT_KERNEL) {
      ++g_other;
    } else if (g_records.size() >= kMaxRecords) {
      ++g_dropped;
    } else {
      // Fields up to `name` have kept their place since CUpti_ActivityKernel4.
      const auto* k = reinterpret_cast<const CUpti_ActivityKernel9*>(rec);
      g_records.push_back(Record{k->start, k->end, k->deviceId, k->streamId, k->correlationId,
                                 intern(k->name), {k->gridX, k->gridY, k->gridZ},
                                 {k->blockX, k->blockY, k->blockZ}});
    }
  }
  size_t dropped = 0;
  if (g_recording && cuptiActivityGetNumDroppedRecords(ctx, stream_id, &dropped) == CUPTI_SUCCESS)
    g_dropped += dropped;
  ++g_buffers;
  free(buffer);
}

// A kernel's name as a JSON string: demangled, quotes and backslashes
// escaped, control characters as \u escapes.
std::string json_name(const std::string& mangled) {
  int status = 0;
  char* out = abi::__cxa_demangle(mangled.c_str(), nullptr, nullptr, &status);
  std::string name = (status == 0 && out != nullptr) ? std::string(out) : mangled;
  free(out);
  std::string s = "\"";
  for (unsigned char c : name) {
    if (c == '"' || c == '\\') {
      s += '\\';
      s += static_cast<char>(c);
    } else if (c < 0x20) {
      char esc[8];
      snprintf(esc, sizeof(esc), "\\u%04x", c);
      s += esc;
    } else {
      s += static_cast<char>(c);
    }
  }
  return s + "\"";
}

}  // namespace

extern "C" {

int sstw_trace_start() {
  {
    std::lock_guard<std::mutex> lock(g_mu);
    g_records.clear();
    g_other = g_dropped = g_buffers = 0;
    g_recording = true;
  }
  // Registered at every start: another CUPTI client of the process (kineto,
  // under torch.profiler) may have registered its own since the last one.
  CUptiResult r = cuptiActivityRegisterCallbacks(buffer_requested, buffer_completed);
  if (r == CUPTI_SUCCESS) r = cuptiActivityEnable(CUPTI_ACTIVITY_KIND_CONCURRENT_KERNEL);
  return static_cast<int>(r);
}

int sstw_trace_stop() {
  CUptiResult r = cuptiActivityDisable(CUPTI_ACTIVITY_KIND_CONCURRENT_KERNEL);
  CUptiResult f = cuptiActivityFlushAll(CUPTI_ACTIVITY_FLAG_FLUSH_FORCED);
  std::lock_guard<std::mutex> lock(g_mu);
  g_recording = false;
  return static_cast<int>(r != CUPTI_SUCCESS ? r : f);
}

void sstw_trace_counts(long long* out) {
  std::lock_guard<std::mutex> lock(g_mu);
  out[0] = static_cast<long long>(g_records.size());
  out[1] = static_cast<long long>(g_other);
  out[2] = static_cast<long long>(g_dropped);
  out[3] = static_cast<long long>(g_buffers);
}

long long sstw_trace_write(const char* path) {
  std::lock_guard<std::mutex> lock(g_mu);
  FILE* f = fopen(path, "w");
  if (f == nullptr) return -1;
  std::vector<std::string> names;
  names.reserve(g_names.size());
  for (const std::string& n : g_names) names.push_back(json_name(n));
  std::string out = "{\"displayTimeUnit\": \"ms\", \"traceEvents\": [";
  char line[256];
  long long n = 0;
  bool ok = true;
  for (const Record& r : g_records) {
    out += n++ ? ",\n{\"ph\": \"X\", \"cat\": \"kernel\", \"name\": "
               : "\n{\"ph\": \"X\", \"cat\": \"kernel\", \"name\": ";
    out += names[r.name];
    const uint64_t dur = r.end > r.start ? r.end - r.start : 0;  // ns
    snprintf(line, sizeof(line),
             ", \"pid\": %u, \"tid\": %u, \"ts\": %llu.%03llu, \"dur\": %llu.%03llu, "
             "\"args\": {\"correlation\": %u, \"grid\": [%d, %d, %d], \"block\": [%d, %d, %d]}}",
             r.device, r.stream, static_cast<unsigned long long>(r.start / 1000),
             static_cast<unsigned long long>(r.start % 1000),
             static_cast<unsigned long long>(dur / 1000),
             static_cast<unsigned long long>(dur % 1000), r.correlation, r.grid[0], r.grid[1],
             r.grid[2], r.block[0], r.block[1], r.block[2]);
    out += line;
    if (out.size() > (1u << 22)) {
      ok = ok && fwrite(out.data(), 1, out.size(), f) == out.size();
      out.clear();
    }
  }
  out += "\n]}\n";
  ok = ok && fwrite(out.data(), 1, out.size(), f) == out.size();
  return (fclose(f) == 0 && ok) ? n : -1;
}

const char* sstw_trace_error(int code) {
  const char* s = nullptr;
  if (cuptiGetResultString(static_cast<CUptiResult>(code), &s) != CUPTI_SUCCESS || !s)
    return "unknown CUPTI result";
  return s;
}

}  // extern "C"
