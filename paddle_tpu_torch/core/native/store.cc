// Native TCPStore server (reference: paddle/phi/core/distributed/store/
// tcp_store.h:121 MasterDaemon + tcp_utils.cc — the reference's rendezvous
// KV store is exactly this C++ daemon; the Python TCPStore class is a thin
// client over it).
//
// Wire protocol (shared with the Python client/fallback server):
//   request : u8 cmd | u32 klen | key | u32 vlen | val | f64 timeout   (BE)
//   response: u8 status (0 ok, 1 timeout, 2 bad, 3 deleted-miss) | u32 vlen | val
//   cmds: 1 SET  2 GET(blocking until key or timeout; a DELETE processed
//           mid-wait answers status 3 instead of stalling)  3 ADD(val=i64 BE)
//         4 DELETE  5 WAIT(key = '\n'-joined key list)
//         6 CAS(val = u32 elen | expected | desired; elen 0 = expect-absent;
//           reply val = u8 swapped | current bytes)
//
// Threading mirrors tcp_store.cc: accept loop + thread per connection over
// one mutex/condvar-protected map. Exposed flat C API for ctypes.
#include <arpa/inet.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <unistd.h>

#include <chrono>
#include <condition_variable>
#include <cstring>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Store {
  std::map<std::string, std::string> kv;
  std::map<std::string, uint64_t> dels;  // key -> deletion generation
  std::mutex mu;
  std::condition_variable cv;
  int listen_fd = -1;
  std::thread accept_thread;
  bool stopping = false;
};

Store* g_store = nullptr;
std::mutex g_mu;

bool read_exact(int fd, void* buf, size_t n) {
  char* p = static_cast<char*>(buf);
  while (n > 0) {
    ssize_t r = ::recv(fd, p, n, 0);
    if (r <= 0) return false;
    p += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

bool write_exact(int fd, const void* buf, size_t n) {
  const char* p = static_cast<const char*>(buf);
  while (n > 0) {
    ssize_t r = ::send(fd, p, n, MSG_NOSIGNAL);
    if (r <= 0) return false;
    p += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

bool read_u32(int fd, uint32_t* v) {
  uint32_t be;
  if (!read_exact(fd, &be, 4)) return false;
  *v = ntohl(be);
  return true;
}

bool read_blob(int fd, std::string* out) {
  uint32_t n;
  if (!read_u32(fd, &n)) return false;
  out->resize(n);
  return n == 0 || read_exact(fd, &(*out)[0], n);
}

bool send_reply(int fd, uint8_t status, const std::string& val) {
  std::string buf;
  buf.push_back(static_cast<char>(status));
  uint32_t be = htonl(static_cast<uint32_t>(val.size()));
  buf.append(reinterpret_cast<char*>(&be), 4);
  buf.append(val);
  return write_exact(fd, buf.data(), buf.size());
}

void serve(Store* st, int fd) {
  for (;;) {
    uint8_t cmd;
    std::string key, val;
    uint64_t tbits;
    if (!read_exact(fd, &cmd, 1) || !read_blob(fd, &key) ||
        !read_blob(fd, &val) || !read_exact(fd, &tbits, 8))
      break;
    uint64_t host_bits = be64toh(tbits);
    double timeout;
    std::memcpy(&timeout, &host_bits, 8);
    auto deadline = std::chrono::steady_clock::now() +
                    std::chrono::duration_cast<std::chrono::steady_clock::duration>(
                        std::chrono::duration<double>(timeout));
    bool ok = true;
    switch (cmd) {
      case 1: {  // SET
        {
          std::lock_guard<std::mutex> lk(st->mu);
          st->kv[key] = val;
        }
        st->cv.notify_all();
        ok = send_reply(fd, 0, "");
        break;
      }
      case 2: {  // GET (blocking; DELETE mid-wait -> typed miss, status 3)
        std::unique_lock<std::mutex> lk(st->mu);
        uint64_t gen0 = st->dels.count(key) ? st->dels[key] : 0;
        st->cv.wait_until(lk, deadline, [&] {
          return st->stopping || st->kv.count(key) != 0 ||
                 (st->dels.count(key) ? st->dels[key] : 0) != gen0;
        });
        if (st->kv.count(key)) {
          ok = send_reply(fd, 0, st->kv[key]);
        } else {
          bool deleted = (st->dels.count(key) ? st->dels[key] : 0) != gen0;
          lk.unlock();
          ok = send_reply(fd, deleted ? 3 : 1, "");
        }
        break;
      }
      case 3: {  // ADD
        int64_t delta = 0;
        if (val.size() == 8) {
          uint64_t be;
          std::memcpy(&be, val.data(), 8);
          delta = static_cast<int64_t>(be64toh(be));
        }
        int64_t cur;
        {
          std::lock_guard<std::mutex> lk(st->mu);
          int64_t prev = 0;
          auto it = st->kv.find(key);
          if (it != st->kv.end()) prev = std::strtoll(it->second.c_str(), nullptr, 10);
          cur = prev + delta;
          st->kv[key] = std::to_string(cur);
        }
        st->cv.notify_all();
        uint64_t be = htobe64(static_cast<uint64_t>(cur));
        ok = send_reply(fd, 0, std::string(reinterpret_cast<char*>(&be), 8));
        break;
      }
      case 4: {  // DELETE
        bool existed;
        {
          std::lock_guard<std::mutex> lk(st->mu);
          existed = st->kv.erase(key) != 0;
          st->dels[key]++;
        }
        st->cv.notify_all();
        ok = send_reply(fd, 0, existed ? "1" : "0");
        break;
      }
      case 6: {  // CAS: expected raw bytes (elen 0 = expect-absent) -> desired
        if (val.size() < 4) {
          ok = send_reply(fd, 2, "");
          break;
        }
        uint32_t elen_be;
        std::memcpy(&elen_be, val.data(), 4);
        uint32_t elen = ntohl(elen_be);
        if (val.size() < 4 + static_cast<size_t>(elen)) {
          ok = send_reply(fd, 2, "");
          break;
        }
        std::string expected = val.substr(4, elen);
        std::string desired = val.substr(4 + elen);
        std::string reply;
        {
          std::lock_guard<std::mutex> lk(st->mu);
          auto it = st->kv.find(key);
          bool swapped = (elen == 0) ? it == st->kv.end()
                                     : (it != st->kv.end() && it->second == expected);
          if (swapped) st->kv[key] = desired;
          reply.push_back(swapped ? '\x01' : '\x00');
          auto cur = st->kv.find(key);
          if (cur != st->kv.end()) reply.append(cur->second);
        }
        st->cv.notify_all();
        ok = send_reply(fd, 0, reply);
        break;
      }
      case 5: {  // WAIT on '\n'-joined keys
        std::vector<std::string> keys;
        size_t pos = 0;
        while (pos <= key.size() && !key.empty()) {
          size_t nl = key.find('\n', pos);
          if (nl == std::string::npos) {
            keys.push_back(key.substr(pos));
            break;
          }
          keys.push_back(key.substr(pos, nl - pos));
          pos = nl + 1;
        }
        bool all = true;
        {
          std::unique_lock<std::mutex> lk(st->mu);
          for (const auto& k : keys) {
            bool have = st->cv.wait_until(lk, deadline, [&] {
              return st->stopping || st->kv.count(k) != 0;
            });
            if (!have || !st->kv.count(k)) {
              all = false;
              break;
            }
          }
        }
        ok = send_reply(fd, all ? 0 : 1, "");
        break;
      }
      default:
        ok = send_reply(fd, 2, "");
    }
    if (!ok) break;
  }
  ::close(fd);
}

void accept_loop(Store* st) {
  for (;;) {
    int fd = ::accept(st->listen_fd, nullptr, nullptr);
    if (fd < 0) return;  // listen socket closed: shut down
    int one = 1;
    ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
    std::thread(serve, st, fd).detach();
  }
}

}  // namespace

extern "C" {

// Start the daemon on host:port (port 0 = ephemeral). Returns the bound
// port, or -1 on error. One daemon per process (the master rank's).
int pt_store_start(const char* host, int port) {
  std::lock_guard<std::mutex> g(g_mu);
  if (g_store != nullptr) return -1;
  int fd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return -1;
  int one = 1;
  ::setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons(static_cast<uint16_t>(port));
  addr.sin_addr.s_addr = host && *host ? ::inet_addr(host) : INADDR_ANY;
  if (::bind(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) != 0 ||
      ::listen(fd, 128) != 0) {
    ::close(fd);
    return -1;
  }
  socklen_t len = sizeof(addr);
  ::getsockname(fd, reinterpret_cast<sockaddr*>(&addr), &len);
  auto* st = new Store();
  st->listen_fd = fd;
  st->accept_thread = std::thread(accept_loop, st);
  st->accept_thread.detach();
  g_store = st;
  return ntohs(addr.sin_port);
}

void pt_store_stop() {
  std::lock_guard<std::mutex> g(g_mu);
  if (g_store == nullptr) return;
  {
    std::lock_guard<std::mutex> lk(g_store->mu);
    g_store->stopping = true;
  }
  g_store->cv.notify_all();
  ::shutdown(g_store->listen_fd, SHUT_RDWR);
  ::close(g_store->listen_fd);
  g_store = nullptr;  // leak the Store: detached threads may still hold it
}

}  // extern "C"
