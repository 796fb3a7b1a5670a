// A c10d backend that runs each collective of device tensors through host
// buffers over an inner CPU gloo backend: the device tensors are copied
// into (pinned) host tensors, the gloo collective runs and is waited on,
// and the results are copied back.  Every collective completes before it
// returns, so its Work is a finished future.  Point-to-point sends and
// receives are posted and return at once (StagedP2PWork): a send's host
// copy is made before it is posted, a receive lands in its device tensor
// when its Work is waited on, so two ranks may each post a send before
// their receive, as over NCCL.
//
// Why: two ranks that share one card cannot form an NCCL communicator, and
// gloo's own CUDA works crash under torch's functional collectives (the
// path DTensor takes).  Registered for "cuda" with
// torch.distributed.Backend.register_backend by
// paddle_tpu_torch/distributed/staged.py; built with g++ against torch's
// headers at first use.
#include <torch/csrc/distributed/c10d/Backend.hpp>
#include <torch/csrc/distributed/c10d/Work.hpp>
#include <torch/csrc/utils/pybind.h>

#include <ATen/ATen.h>

#include <cstdint>
#include <map>
#include <mutex>
#include <string>
#include <utility>
#include <vector>

namespace {

using c10d::Work;

// calls and payload bytes (what this rank hands the collective) by kind,
// for the process: read by staged.counts(), zeroed by staged.reset_counts()
std::mutex g_mu;
std::map<std::string, std::pair<int64_t, int64_t>> g_counts;

int64_t nbytes(const at::Tensor& t) { return t.numel() * t.element_size(); }

int64_t nbytes(const std::vector<at::Tensor>& ts) {
  int64_t n = 0;
  for (const auto& t : ts) n += nbytes(t);
  return n;
}

void count(const char* kind, int64_t bytes) {
  std::lock_guard<std::mutex> g(g_mu);
  auto& c = g_counts[kind];
  c.first += 1;
  c.second += bytes;
}

at::Tensor host_like(const at::Tensor& t) {
  auto opts = t.options().device(at::kCPU);
  if (t.is_cuda()) opts = opts.pinned_memory(true);
  return at::empty(t.sizes(), opts);
}

at::Tensor to_host(const at::Tensor& t) {
  at::Tensor h = host_like(t);
  h.copy_(t);
  return h;
}

std::vector<at::Tensor> to_host(const std::vector<at::Tensor>& ts) {
  std::vector<at::Tensor> out;
  out.reserve(ts.size());
  for (const auto& t : ts) out.push_back(to_host(t));
  return out;
}

std::vector<at::Tensor> empty_host(const std::vector<at::Tensor>& ts) {
  std::vector<at::Tensor> out;
  out.reserve(ts.size());
  for (const auto& t : ts) out.push_back(host_like(t));
  return out;
}

void copy_back(std::vector<at::Tensor>& dst, const std::vector<at::Tensor>& src) {
  for (size_t i = 0; i < dst.size(); ++i) dst[i].copy_(src[i]);
}

c10::intrusive_ptr<Work> done(const std::vector<at::Tensor>& result) {
  auto fut = c10::make_intrusive<c10::ivalue::Future>(
      c10::ListType::create(c10::TensorType::get()));
  fut->markCompleted(c10::IValue(result));
  return Work::create_from_future(fut);
}

// A posted gloo send or receive of host buffers: waiting on it waits on
// the gloo work and, for a receive, copies the host buffers into the
// device tensors.  It holds the host buffers until then.
class StagedP2PWork : public Work {
 public:
  StagedP2PWork(c10::intrusive_ptr<Work> inner, std::vector<at::Tensor> host,
                std::vector<at::Tensor> dst, c10d::OpType type)
      : Work(-1, type), inner_(std::move(inner)), host_(std::move(host)),
        dst_(std::move(dst)) {}

  bool isCompleted() override {
    std::lock_guard<std::mutex> g(mu_);
    return landed_;
  }

  bool isSuccess() const override { return true; }

  bool wait(std::chrono::milliseconds timeout) override {
    std::lock_guard<std::mutex> g(mu_);
    if (!landed_) {
      inner_->wait(timeout);
      copy_back(dst_, host_);
      landed_ = true;
    }
    return true;
  }

  void abort() override { inner_->abort(); }

 private:
  std::mutex mu_;
  bool landed_ = false;
  c10::intrusive_ptr<Work> inner_;
  std::vector<at::Tensor> host_;
  std::vector<at::Tensor> dst_;   // empty for a send
};

class StagedBackend : public c10d::Backend {
 public:
  StagedBackend(c10::intrusive_ptr<c10d::Backend> inner, int rank, int size)
      : c10d::Backend(rank, size), inner_(std::move(inner)) {}

  const std::string getBackendName() const override { return "staged"; }

  c10::intrusive_ptr<Work> broadcast(
      std::vector<at::Tensor>& tensors,
      const c10d::BroadcastOptions& opts) override {
    count("broadcast", nbytes(tensors));
    auto h = to_host(tensors);
    inner_->broadcast(h, opts)->wait();
    copy_back(tensors, h);
    return done(tensors);
  }

  c10::intrusive_ptr<Work> allreduce(
      std::vector<at::Tensor>& tensors,
      const c10d::AllreduceOptions& opts) override {
    count("all_reduce", nbytes(tensors));
    auto h = to_host(tensors);
    inner_->allreduce(h, opts)->wait();
    copy_back(tensors, h);
    return done(tensors);
  }

  c10::intrusive_ptr<Work> allreduce_coalesced(
      std::vector<at::Tensor>& tensors,
      const c10d::AllreduceCoalescedOptions& opts) override {
    count("all_reduce", nbytes(tensors));
    auto h = to_host(tensors);
    inner_->allreduce_coalesced(h, opts)->wait();
    copy_back(tensors, h);
    return done(tensors);
  }

  c10::intrusive_ptr<Work> reduce(
      std::vector<at::Tensor>& tensors,
      const c10d::ReduceOptions& opts) override {
    count("reduce", nbytes(tensors));
    auto h = to_host(tensors);
    inner_->reduce(h, opts)->wait();
    copy_back(tensors, h);
    return done(tensors);
  }

  c10::intrusive_ptr<Work> allgather(
      std::vector<std::vector<at::Tensor>>& outputs,
      std::vector<at::Tensor>& inputs,
      const c10d::AllgatherOptions& opts) override {
    count("all_gather", nbytes(inputs));
    auto hin = to_host(inputs);
    std::vector<std::vector<at::Tensor>> hout;
    for (auto& l : outputs) hout.push_back(empty_host(l));
    inner_->allgather(hout, hin, opts)->wait();
    std::vector<at::Tensor> flat;
    for (size_t i = 0; i < outputs.size(); ++i) {
      copy_back(outputs[i], hout[i]);
      flat.insert(flat.end(), outputs[i].begin(), outputs[i].end());
    }
    return done(flat);
  }

  c10::intrusive_ptr<Work> _allgather_base(
      at::Tensor& output, at::Tensor& input,
      const c10d::AllgatherOptions& opts) override {
    count("all_gather", nbytes(input));
    at::Tensor hin = to_host(input), hout = host_like(output);
    inner_->_allgather_base(hout, hin, opts)->wait();
    output.copy_(hout);
    return done({output});
  }

  c10::intrusive_ptr<Work> allgather_into_tensor_coalesced(
      std::vector<at::Tensor>& outputs, std::vector<at::Tensor>& inputs,
      const c10d::AllgatherOptions& opts) override {
    for (size_t i = 0; i < outputs.size(); ++i) {
      _allgather_base(outputs[i], inputs[i], opts);
    }
    return done(outputs);
  }

  c10::intrusive_ptr<Work> gather(
      std::vector<std::vector<at::Tensor>>& outputs,
      std::vector<at::Tensor>& inputs,
      const c10d::GatherOptions& opts) override {
    count("gather", nbytes(inputs));
    auto hin = to_host(inputs);
    std::vector<std::vector<at::Tensor>> hout;
    for (auto& l : outputs) hout.push_back(empty_host(l));
    inner_->gather(hout, hin, opts)->wait();
    for (size_t i = 0; i < outputs.size(); ++i) copy_back(outputs[i], hout[i]);
    return done(inputs);
  }

  c10::intrusive_ptr<Work> scatter(
      std::vector<at::Tensor>& outputs,
      std::vector<std::vector<at::Tensor>>& inputs,
      const c10d::ScatterOptions& opts) override {
    count("scatter", nbytes(outputs));
    auto hout = empty_host(outputs);
    std::vector<std::vector<at::Tensor>> hin;
    for (auto& l : inputs) hin.push_back(to_host(l));
    inner_->scatter(hout, hin, opts)->wait();
    copy_back(outputs, hout);
    return done(outputs);
  }

  c10::intrusive_ptr<Work> reduce_scatter(
      std::vector<at::Tensor>& outputs,
      std::vector<std::vector<at::Tensor>>& inputs,
      const c10d::ReduceScatterOptions& opts) override {
    count("reduce_scatter", nbytes(outputs) * size_);
    auto hout = empty_host(outputs);
    std::vector<std::vector<at::Tensor>> hin;
    for (auto& l : inputs) hin.push_back(to_host(l));
    inner_->reduce_scatter(hout, hin, opts)->wait();
    copy_back(outputs, hout);
    return done(outputs);
  }

  c10::intrusive_ptr<Work> _reduce_scatter_base(
      at::Tensor& output, at::Tensor& input,
      const c10d::ReduceScatterOptions& opts) override {
    count("reduce_scatter", nbytes(input));
    at::Tensor hin = to_host(input), hout = host_like(output);
    inner_->_reduce_scatter_base(hout, hin, opts)->wait();
    output.copy_(hout);
    return done({output});
  }

  c10::intrusive_ptr<Work> reduce_scatter_tensor_coalesced(
      std::vector<at::Tensor>& outputs, std::vector<at::Tensor>& inputs,
      const c10d::ReduceScatterOptions& opts) override {
    for (size_t i = 0; i < outputs.size(); ++i) {
      _reduce_scatter_base(outputs[i], inputs[i], opts);
    }
    return done(outputs);
  }

  c10::intrusive_ptr<Work> alltoall_base(
      at::Tensor& output, at::Tensor& input,
      std::vector<int64_t>& outputSplitSizes,
      std::vector<int64_t>& inputSplitSizes,
      const c10d::AllToAllOptions& opts) override {
    count("all_to_all", nbytes(input));
    at::Tensor hin = to_host(input), hout = host_like(output);
    inner_->alltoall_base(hout, hin, outputSplitSizes, inputSplitSizes, opts)
        ->wait();
    output.copy_(hout);
    return done({output});
  }

  c10::intrusive_ptr<Work> send(
      std::vector<at::Tensor>& tensors, int dstRank, int tag) override {
    count("send", nbytes(tensors));
    auto h = to_host(tensors);
    auto w = inner_->send(h, dstRank, tag);
    return c10::make_intrusive<StagedP2PWork>(
        std::move(w), std::move(h), std::vector<at::Tensor>{},
        c10d::OpType::SEND);
  }

  c10::intrusive_ptr<Work> recv(
      std::vector<at::Tensor>& tensors, int srcRank, int tag) override {
    count("recv", nbytes(tensors));
    auto h = empty_host(tensors);
    auto w = inner_->recv(h, srcRank, tag);
    return c10::make_intrusive<StagedP2PWork>(std::move(w), std::move(h),
                                              tensors, c10d::OpType::RECV);
  }

  c10::intrusive_ptr<Work> barrier(const c10d::BarrierOptions& opts) override {
    count("barrier", 0);
    inner_->barrier(opts)->wait();
    return done({});
  }

 private:
  c10::intrusive_ptr<c10d::Backend> inner_;
};

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  py::class_<StagedBackend, c10d::Backend, c10::intrusive_ptr<StagedBackend>>(
      m, "StagedBackend")
      .def(py::init<c10::intrusive_ptr<c10d::Backend>, int, int>());
  m.def("counts", [] {
    std::lock_guard<std::mutex> g(g_mu);
    py::dict out;
    for (const auto& kv : g_counts) {
      out[py::str(kv.first)] = py::make_tuple(kv.second.first, kv.second.second);
    }
    return out;
  });
  m.def("reset_counts", [] {
    std::lock_guard<std::mutex> g(g_mu);
    g_counts.clear();
  });
}
