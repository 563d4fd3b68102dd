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
//   * the records are CUPTI's conversion of the card's timestamps, which in
//     some processes drifts from the host's clock by hundreds of parts per
//     million or more; so the recorder puts the records themselves beside
//     CLOCK_MONOTONIC (time.perf_counter_ns in Python): at its start, at its
//     stop and at each sstw_trace_mark() it launches marker kernels (an empty
//     PTX kernel, sstw_trace_marker, on a stream of its own, through the
//     driver API and outside the interpreter lock), each between a monotonic
//     read before its launch and one after its stream's synchronise. A
//     marker's record lies inside that bracket, so each bounds the records'
//     offset from the host's clock from both sides; the markers' records are
//     kept apart from the kernels', and their block and grid sizes carry
//     each marker's number;
//   * sstw_trace_copy copies the kept records' start and end times out of
//     the vector, for the join of host spans and kernels after the trace.
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
//   sstw_trace_device(ordinal)  the device the markers run on (before a start)
//   sstw_trace_mark()       one group of markers (0, or -1 without the driver;
//                           the caller holds graph captures back meanwhile)
//   sstw_trace_marks(out, cap)  rows of 5: group, monotonic ns before the
//                           launch and after the synchronise, the record's
//                           start and end (CUPTI's clock), for each marker
//                           of the last start..stop with a record: the rows
//   sstw_trace_copy(starts, ends, cap)  the kept records' start and end
//                           (ns, CUPTI's clock), at most cap: the number copied

#include <cupti.h>
#include <cxxabi.h>
#include <dlfcn.h>

#include <time.h>

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
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

long long monotonic_ns() {
  timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return static_cast<long long>(ts.tv_sec) * 1000000000LL + ts.tv_nsec;
}

// The markers: the host's brackets and, once CUPTI delivers it, each one's
// record. Index = the marker's number in the trace.
struct Mark {
  long long group, before, after;  // monotonic ns before the launch, after the synchronise
  uint64_t start, end;             // the record (0 until it arrives)
};
std::vector<Mark> g_marks;
long long g_group = 0;
int32_t g_marker_name = -1;  // the marker kernel's index in g_names
constexpr char kMarkerName[] = "sstw_trace_marker";
constexpr int kMarkersAtEnds = 8, kMarkersBetween = 3;
constexpr char kMarkerPtx[] =
    ".version 7.0\n.target sm_70\n.address_size 64\n"
    ".visible .entry sstw_trace_marker()\n{\n  ret;\n}\n";

// The driver API, from the libcuda PyTorch loaded (no link-time CUDA).
struct Driver {
  CUresult (*device_get)(CUdevice*, int);
  CUresult (*primary_retain)(CUcontext*, CUdevice);
  CUresult (*push)(CUcontext);
  CUresult (*pop)(CUcontext*);
  CUresult (*module_load)(CUmodule*, const void*);
  CUresult (*get_function)(CUfunction*, CUmodule, const char*);
  CUresult (*stream_create)(CUstream*, unsigned int);
  CUresult (*sync)(CUstream);
  CUresult (*launch)(CUfunction, unsigned, unsigned, unsigned, unsigned, unsigned, unsigned,
                     unsigned, CUstream, void**, void**);
};
Driver g_cu{};
int g_device = 0;
int g_marker_state = 0;  // 0 not tried, 1 ready, -1 failed
CUcontext g_ctx = nullptr;
CUfunction g_marker = nullptr;
CUstream g_marker_stream = nullptr;

template <typename F>
bool bind(void* lib, const char* name, F* out) {
  *out = reinterpret_cast<F>(dlsym(lib, name));
  return *out != nullptr;
}

// Load the marker kernel on g_device and run it once (before CUPTI records,
// so its load and first launch fall outside every bracket).
bool markers_ready() {
  if (g_marker_state != 0) return g_marker_state > 0;
  g_marker_state = -1;
  void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
  if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
  if (lib == nullptr) return false;
  Driver d{};
  if (!(bind(lib, "cuDeviceGet", &d.device_get) &&
        bind(lib, "cuDevicePrimaryCtxRetain", &d.primary_retain) &&
        bind(lib, "cuCtxPushCurrent_v2", &d.push) && bind(lib, "cuCtxPopCurrent_v2", &d.pop) &&
        bind(lib, "cuModuleLoadData", &d.module_load) &&
        bind(lib, "cuModuleGetFunction", &d.get_function) &&
        bind(lib, "cuStreamCreate", &d.stream_create) &&
        bind(lib, "cuStreamSynchronize", &d.sync) && bind(lib, "cuLaunchKernel", &d.launch)))
    return false;
  CUdevice dev;
  CUmodule mod;
  if (d.device_get(&dev, g_device) != CUDA_SUCCESS ||
      d.primary_retain(&g_ctx, dev) != CUDA_SUCCESS || d.push(g_ctx) != CUDA_SUCCESS)
    return false;
  bool ok = d.module_load(&mod, kMarkerPtx) == CUDA_SUCCESS &&
            d.get_function(&g_marker, mod, kMarkerName) == CUDA_SUCCESS &&
            d.stream_create(&g_marker_stream, CU_STREAM_NON_BLOCKING) == CUDA_SUCCESS &&
            d.launch(g_marker, 1, 1, 1, 1, 1, 1, 0, g_marker_stream, nullptr, nullptr) ==
                CUDA_SUCCESS &&
            d.sync(g_marker_stream) == CUDA_SUCCESS;
  CUcontext popped;
  d.pop(&popped);
  if (!ok) return false;
  g_cu = d;
  g_marker_state = 1;
  return true;
}

// A group of n markers, one after another: each launched between two
// monotonic reads with its stream synchronised. Its number rides in its
// block and grid sizes. 0, or -1 without markers.
int mark_group(int n) {
  if (!markers_ready()) return -1;
  if (g_cu.push(g_ctx) != CUDA_SUCCESS) return -1;
  const long long group = g_group++;
  for (int i = 0; i < n; ++i) {
    size_t seq;
    {
      std::lock_guard<std::mutex> lock(g_mu);
      seq = g_marks.size();
      g_marks.push_back(Mark{group, 0, 0, 0, 0});
    }
    const long long before = monotonic_ns();
    if (g_cu.launch(g_marker, 1 + static_cast<unsigned>(seq / 1024), 1, 1,
                    1 + static_cast<unsigned>(seq % 1024), 1, 1, 0, g_marker_stream, nullptr,
                    nullptr) != CUDA_SUCCESS ||
        g_cu.sync(g_marker_stream) != CUDA_SUCCESS)
      break;
    const long long after = monotonic_ns();
    std::lock_guard<std::mutex> lock(g_mu);
    g_marks[seq].before = before;
    g_marks[seq].after = after;
  }
  CUcontext popped;
  g_cu.pop(&popped);
  return 0;
}

int32_t intern(const char* name) {
  if (name == nullptr) name = "?";
  auto it = g_name_index.find(name);
  if (it != g_name_index.end()) return it->second;
  int32_t id = static_cast<int32_t>(g_names.size());
  g_names.emplace_back(name);
  g_name_index.emplace(name, id);
  if (strcmp(name, kMarkerName) == 0) g_marker_name = id;
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
      continue;
    }
    // Fields up to `name` have kept their place since CUpti_ActivityKernel4.
    const auto* k = reinterpret_cast<const CUpti_ActivityKernel9*>(rec);
    const int32_t name = intern(k->name);
    if (name == g_marker_name) {
      const size_t seq = static_cast<size_t>(k->gridX - 1) * 1024 + (k->blockX - 1);
      if (seq < g_marks.size()) {
        g_marks[seq].start = k->start;
        g_marks[seq].end = k->end;
      }
    } else if (g_records.size() >= kMaxRecords) {
      ++g_dropped;
    } else {
      g_records.push_back(Record{k->start, k->end, k->deviceId, k->streamId, k->correlationId,
                                 name, {k->gridX, k->gridY, k->gridZ},
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

void sstw_trace_device(int ordinal) { g_device = ordinal; }

int sstw_trace_start() {
  markers_ready();  // loaded and run once before CUPTI records
  {
    std::lock_guard<std::mutex> lock(g_mu);
    g_records.clear();
    g_marks.clear();
    g_group = 0;
    g_other = g_dropped = g_buffers = 0;
    g_recording = true;
  }
  // Registered at every start: another CUPTI client of the process (kineto,
  // under torch.profiler) may have registered its own since the last one.
  CUptiResult r = cuptiActivityRegisterCallbacks(buffer_requested, buffer_completed);
  if (r == CUPTI_SUCCESS) r = cuptiActivityEnable(CUPTI_ACTIVITY_KIND_CONCURRENT_KERNEL);
  if (r == CUPTI_SUCCESS) mark_group(kMarkersAtEnds);
  return static_cast<int>(r);
}

int sstw_trace_mark() { return mark_group(kMarkersBetween); }

int sstw_trace_stop() {
  mark_group(kMarkersAtEnds);
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

long long sstw_trace_marks(long long* out, long long cap) {
  std::lock_guard<std::mutex> lock(g_mu);
  long long n = 0;
  for (const Mark& m : g_marks) {
    if (n >= cap) break;
    if (m.after == 0 || m.end == 0) continue;  // not run, or no record
    long long* row = out + 5 * n++;
    row[0] = m.group;
    row[1] = m.before;
    row[2] = m.after;
    row[3] = static_cast<long long>(m.start);
    row[4] = static_cast<long long>(m.end);
  }
  return n;
}

long long sstw_trace_copy(unsigned long long* starts, unsigned long long* ends, long long cap) {
  std::lock_guard<std::mutex> lock(g_mu);
  long long n = 0;
  for (const Record& r : g_records) {
    if (n >= cap) break;
    starts[n] = r.start;
    ends[n] = r.end;
    ++n;
  }
  return n;
}

const char* sstw_trace_error(int code) {
  const char* s = nullptr;
  if (cuptiGetResultString(static_cast<CUptiResult>(code), &s) != CUPTI_SUCCESS || !s)
    return "unknown CUPTI result";
  return s;
}

}  // extern "C"
