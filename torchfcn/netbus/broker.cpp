// torchfcn_bus_broker — native cross-process topic broker (a copy of
// tpufcn/netbus/broker.cpp for the port, the same wire protocol).
//
// The reference's inter-process fabric is ROS/TCPROS: each node is its
// own OS process and topics travel over TCP with tcp_nodelay and
// bounded drop-oldest queues (reference scripts/fcn_object_detector.py
// :330-331 subscribes with tcp_nodelay=True and publishes with
// queue_size=1; launch/fcn_point_map.launch:3-19 wires a multi-process
// graph).  This broker is the equivalent of that native fabric:
// a single-threaded poll(2) event loop that forwards publish frames
// between connected node processes.  It never deserializes payloads —
// frames are opaque bytes after the topic header — so the hot path is
// socket reads and writes only.
//
// Wire protocol (shared with torchfcn/serve/netbus.py, the Python client
// and the pure-Python fallback broker):
//
//   frame   := u32_be length | u8 kind | body       (length = 1 + len(body))
//   SUB     := kind 0x01, body = topic utf-8
//   UNSUB   := kind 0x02, body = topic utf-8
//   PUB     := kind 0x03, body = u16_be topic_len | topic |
//              f64_be stamp | u64_be seq | payload
//
// A PUB frame is forwarded verbatim to every OTHER connection
// subscribed to its topic (the publishing process delivers to its own
// local subscribers directly, like the in-process TopicBus).  Each
// connection has a bounded outbox (frames); when a slow subscriber
// falls behind, the OLDEST queued frames are dropped — the same
// drop-oldest stance the in-process bus and the reference's
// queue_size=1 publishers take (stale frames are worthless in a live
// vision pipeline).
//
// Trust model: identical to TCPROS — an unauthenticated fabric for a
// trusted robot LAN.  Do not expose the port publicly.

#include <arpa/inet.h>
#include <cerrno>
#include <csignal>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <map>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <poll.h>
#include <set>
#include <string>
#include <sys/socket.h>
#include <unistd.h>
#include <vector>

namespace {

constexpr uint8_t kSub = 0x01;
constexpr uint8_t kUnsub = 0x02;
constexpr uint8_t kPub = 0x03;
constexpr size_t kMaxFrame = 1u << 30;  // 1 GiB sanity cap

volatile std::sig_atomic_t g_stop = 0;
void handle_stop(int) { g_stop = 1; }

struct Conn {
  std::string rbuf;                  // partial inbound bytes
  std::deque<std::string> outbox;    // whole frames awaiting write
  size_t woff = 0;                   // bytes of outbox.front() already sent
  std::set<std::string> topics;
};

struct Broker {
  int listen_fd = -1;
  size_t max_outbox;
  std::map<int, Conn> conns;
  std::map<std::string, std::set<int>> subs;

  explicit Broker(size_t max_outbox_frames) : max_outbox(max_outbox_frames) {}

  void drop(int fd) {
    auto it = conns.find(fd);
    if (it == conns.end()) return;
    for (const auto& t : it->second.topics) {
      auto s = subs.find(t);
      if (s != subs.end()) {
        s->second.erase(fd);
        if (s->second.empty()) subs.erase(s);
      }
    }
    conns.erase(it);
    ::close(fd);
  }

  void enqueue(int fd, const std::string& frame) {
    Conn& c = conns[fd];
    c.outbox.push_back(frame);
    while (c.outbox.size() > max_outbox) {
      // never drop the frame currently mid-write
      if (c.woff > 0 && c.outbox.size() >= 2) {
        c.outbox.erase(c.outbox.begin() + 1);
      } else if (c.woff == 0) {
        c.outbox.pop_front();
      } else {
        break;
      }
    }
  }

  // Returns false when the connection must be dropped (protocol error).
  bool handle_frame(int fd, const char* body, size_t n) {
    if (n < 1) return false;
    uint8_t kind = static_cast<uint8_t>(body[0]);
    const char* p = body + 1;
    size_t rest = n - 1;
    if (kind == kSub || kind == kUnsub) {
      std::string topic(p, rest);
      if (kind == kSub) {
        conns[fd].topics.insert(topic);
        subs[topic].insert(fd);
      } else {
        conns[fd].topics.erase(topic);
        auto s = subs.find(topic);
        if (s != subs.end()) {
          s->second.erase(fd);
          if (s->second.empty()) subs.erase(s);
        }
      }
      return true;
    }
    if (kind == kPub) {
      if (rest < 2) return false;
      uint16_t tlen;
      std::memcpy(&tlen, p, 2);
      tlen = ntohs(tlen);
      if (rest < 2u + tlen) return false;
      std::string topic(p + 2, tlen);
      auto s = subs.find(topic);
      if (s == subs.end()) return true;
      // rebuild the full frame once, share it across receivers
      std::string frame;
      frame.resize(4 + 1 + n - 1);
      uint32_t len = htonl(static_cast<uint32_t>(n));
      std::memcpy(&frame[0], &len, 4);
      frame[4] = static_cast<char>(kPub);
      std::memcpy(&frame[5], p, n - 1);
      for (int rfd : s->second) {
        if (rfd == fd) continue;  // origin delivers to itself locally
        enqueue(rfd, frame);
      }
      return true;
    }
    return false;  // unknown kind: protocol error
  }

  // Parse as many complete frames as rbuf holds.
  bool drain_rbuf(int fd) {
    Conn& c = conns[fd];
    size_t off = 0;
    while (c.rbuf.size() - off >= 4) {
      uint32_t len;
      std::memcpy(&len, c.rbuf.data() + off, 4);
      len = ntohl(len);
      if (len == 0 || len > kMaxFrame) return false;
      if (c.rbuf.size() - off - 4 < len) break;
      if (!handle_frame(fd, c.rbuf.data() + off + 4, len)) return false;
      off += 4 + len;
    }
    if (off) c.rbuf.erase(0, off);
    return true;
  }
};

}  // namespace

int main(int argc, char** argv) {
  int port = 0;
  size_t max_outbox = 64;
  for (int i = 1; i < argc; ++i) {
    if (!std::strcmp(argv[i], "--port") && i + 1 < argc) {
      port = std::atoi(argv[++i]);
    } else if (!std::strcmp(argv[i], "--max-outbox") && i + 1 < argc) {
      max_outbox = static_cast<size_t>(std::atoll(argv[++i]));
    } else {
      std::fprintf(stderr,
                   "usage: %s [--port P] [--max-outbox N]\n", argv[0]);
      return 2;
    }
  }

  std::signal(SIGINT, handle_stop);
  std::signal(SIGTERM, handle_stop);
  std::signal(SIGPIPE, SIG_IGN);

  Broker broker(max_outbox);
  broker.listen_fd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (broker.listen_fd < 0) { std::perror("socket"); return 1; }
  int one = 1;
  ::setsockopt(broker.listen_fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(INADDR_LOOPBACK);
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (::bind(broker.listen_fd, reinterpret_cast<sockaddr*>(&addr),
             sizeof(addr)) < 0) {
    std::perror("bind");
    return 1;
  }
  if (::listen(broker.listen_fd, 64) < 0) { std::perror("listen"); return 1; }
  socklen_t alen = sizeof(addr);
  ::getsockname(broker.listen_fd, reinterpret_cast<sockaddr*>(&addr), &alen);
  // the launcher (tests, cli bus) parses this line for the chosen port
  std::printf("PORT %d\n", ntohs(addr.sin_port));
  std::fflush(stdout);

  std::vector<pollfd> pfds;
  char buf[1 << 16];
  while (!g_stop) {
    pfds.clear();
    pfds.push_back({broker.listen_fd, POLLIN, 0});
    for (auto& kv : broker.conns) {
      short ev = POLLIN;
      if (!kv.second.outbox.empty()) ev |= POLLOUT;
      pfds.push_back({kv.first, ev, 0});
    }
    int rc = ::poll(pfds.data(), static_cast<nfds_t>(pfds.size()), 500);
    if (rc < 0) {
      if (errno == EINTR) continue;
      std::perror("poll");
      break;
    }
    if (pfds[0].revents & POLLIN) {
      int fd = ::accept(broker.listen_fd, nullptr, nullptr);
      if (fd >= 0) {
        ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
        broker.conns[fd];  // default-construct
      }
    }
    for (size_t i = 1; i < pfds.size(); ++i) {
      int fd = pfds[i].fd;
      short re = pfds[i].revents;
      if (!re) continue;
      if (re & (POLLERR | POLLHUP | POLLNVAL)) { broker.drop(fd); continue; }
      if (re & POLLIN) {
        ssize_t n = ::recv(fd, buf, sizeof(buf), 0);
        if (n <= 0) { broker.drop(fd); continue; }
        broker.conns[fd].rbuf.append(buf, static_cast<size_t>(n));
        if (!broker.drain_rbuf(fd)) { broker.drop(fd); continue; }
      }
      if (re & POLLOUT) {
        Conn& c = broker.conns[fd];
        bool dead = false;
        while (!c.outbox.empty()) {
          const std::string& f = c.outbox.front();
          ssize_t n = ::send(fd, f.data() + c.woff, f.size() - c.woff,
                             MSG_NOSIGNAL);
          if (n < 0) {
            if (errno == EAGAIN || errno == EWOULDBLOCK) break;
            dead = true;
            break;
          }
          c.woff += static_cast<size_t>(n);
          if (c.woff == f.size()) {
            c.outbox.pop_front();
            c.woff = 0;
          } else {
            break;  // kernel buffer full
          }
        }
        if (dead) broker.drop(fd);
      }
    }
  }
  for (auto& kv : broker.conns) ::close(kv.first);
  ::close(broker.listen_fd);
  return 0;
}
