// transferd.cpp — native classical-channel transport for qtpu.
//
// Reference capability: remotecrypto/transferd.c (SURVEY.md §3 #8, §4.5) —
// the single authenticated TCP connection per party pair that ships framed
// messages both ways.  The reference is a select()-loop C daemon moving
// files; this is a C++ library embedded in the pipeline process: a
// background I/O thread drives a non-blocking socket (epoll), sends drain
// from an outbound queue, and completed inbound frames land in a receive
// queue — so Python-side compute (device dispatch) never blocks on the wire
// and a slow peer can't stall reconciliation.
//
// Wire format: 4-byte little-endian length prefix + payload (identical to
// qtpu.link.TcpLink, interoperable).
//
// C API (ctypes-friendly); all functions are thread-safe w.r.t. one handle:
//   td_listen(host, port)            -> handle (blocks until peer connects)
//   td_connect(host, port, retries)  -> handle
//   td_send(h, buf, len)             -> 0 ok / -1 error      (enqueue)
//   td_recv(h, buf, cap, timeout_ms) -> n bytes / 0 timeout / -1 error / -2 buffer too small
//   td_pending(h)                    -> frames waiting
//   td_bytes_sent(h) / td_bytes_received(h)
//   td_close(h)
//
// Build: g++ -O2 -shared -fPIC -o libqtpu_transferd.so transferd.cpp -lpthread

#include <arpa/inet.h>
#include <cerrno>
#include <chrono>
#include <fcntl.h>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <netdb.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <string>
#include <sys/epoll.h>
#include <sys/socket.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

struct Frame {
  std::vector<uint8_t> data;
};

struct Channel {
  int fd = -1;
  int epfd = -1;
  int wake_r = -1, wake_w = -1;  // self-pipe to wake the I/O thread for sends
  std::thread io;
  std::mutex mu;
  std::condition_variable rx_cv;
  std::deque<Frame> tx;      // outbound frames (unframed payloads)
  std::deque<Frame> rx;      // completed inbound frames
  // in-flight send state
  std::vector<uint8_t> send_buf;
  size_t send_off = 0;
  // in-flight receive state
  std::vector<uint8_t> recv_buf;
  uint32_t expect = 0;       // payload length once header parsed, 0 = header
  uint64_t bytes_sent = 0, bytes_received = 0;
  bool dead = false;
  bool stop = false;

  ~Channel() { shutdown(); }

  void shutdown() {
    {
      std::lock_guard<std::mutex> l(mu);
      stop = true;
    }
    if (wake_w >= 0) { uint8_t b = 1; ::write(wake_w, &b, 1); }
    if (io.joinable()) io.join();
    for (int* f : {&fd, &epfd, &wake_r, &wake_w}) {
      if (*f >= 0) { ::close(*f); *f = -1; }
    }
  }

  void mark_dead() {
    std::lock_guard<std::mutex> l(mu);
    dead = true;
    rx_cv.notify_all();
  }

  bool drain_sends_locked() {
    // Called from the I/O thread with mu held; returns false on fatal error.
    for (;;) {
      if (send_buf.empty()) {
        if (tx.empty()) return true;
        Frame f = std::move(tx.front());
        tx.pop_front();
        uint32_t n = static_cast<uint32_t>(f.data.size());
        send_buf.resize(4 + n);
        std::memcpy(send_buf.data(), &n, 4);  // little-endian on x86
        std::memcpy(send_buf.data() + 4, f.data.data(), n);
        send_off = 0;
      }
      while (send_off < send_buf.size()) {
        ssize_t w = ::send(fd, send_buf.data() + send_off,
                           send_buf.size() - send_off, MSG_NOSIGNAL);
        if (w > 0) {
          send_off += static_cast<size_t>(w);
          bytes_sent += static_cast<uint64_t>(w);
        } else if (w < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) {
          return true;  // socket full; epoll will wake us on EPOLLOUT
        } else {
          return false;
        }
      }
      send_buf.clear();
      send_off = 0;
    }
  }

  bool drain_recvs() {
    // Reads everything available; parses length-prefixed frames.
    uint8_t buf[1 << 16];
    for (;;) {
      ssize_t r = ::recv(fd, buf, sizeof(buf), 0);
      if (r > 0) {
        std::lock_guard<std::mutex> l(mu);
        bytes_received += static_cast<uint64_t>(r);
        recv_buf.insert(recv_buf.end(), buf, buf + r);
        for (;;) {
          if (expect == 0) {
            if (recv_buf.size() < 4) break;
            std::memcpy(&expect, recv_buf.data(), 4);
            recv_buf.erase(recv_buf.begin(), recv_buf.begin() + 4);
            if (expect == 0) continue;  // empty frame: skip
          }
          if (recv_buf.size() < expect) break;
          Frame f;
          f.data.assign(recv_buf.begin(), recv_buf.begin() + expect);
          recv_buf.erase(recv_buf.begin(), recv_buf.begin() + expect);
          expect = 0;
          rx.push_back(std::move(f));
          rx_cv.notify_one();
        }
      } else if (r < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) {
        return true;
      } else {
        return false;  // peer closed (r == 0) or error
      }
    }
  }

  void io_loop() {
    epoll_event evs[4];
    for (;;) {
      {
        std::lock_guard<std::mutex> l(mu);
        if (stop) return;
        // Re-arm EPOLLOUT only while there is something to send.
        epoll_event ev{};
        ev.events = EPOLLIN |
                    ((send_buf.size() > send_off || !tx.empty()) ? EPOLLOUT : 0u);
        ev.data.fd = fd;
        epoll_ctl(epfd, EPOLL_CTL_MOD, fd, &ev);
      }
      int n = epoll_wait(epfd, evs, 4, 500);
      if (n < 0 && errno != EINTR) { mark_dead(); return; }
      bool want_send = false;
      for (int i = 0; i < n; i++) {
        if (evs[i].data.fd == wake_r) {
          uint8_t tmp[64];
          while (::read(wake_r, tmp, sizeof(tmp)) > 0) {}
          want_send = true;
        } else {
          if (evs[i].events & EPOLLIN) {
            if (!drain_recvs()) { mark_dead(); return; }
          }
          if (evs[i].events & (EPOLLOUT | EPOLLERR | EPOLLHUP)) want_send = true;
        }
      }
      if (want_send || true) {
        std::lock_guard<std::mutex> l(mu);
        if (stop) return;
        if (!drain_sends_locked()) { mark_dead(); return; }
      }
    }
  }
};

int setup_common(Channel* ch, int sock) {
  int one = 1;
  setsockopt(sock, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  int buf = 8 * 1024 * 1024;
  setsockopt(sock, SOL_SOCKET, SO_SNDBUF, &buf, sizeof(buf));
  setsockopt(sock, SOL_SOCKET, SO_RCVBUF, &buf, sizeof(buf));
  // Non-blocking socket driven by epoll.
  int flags = fcntl(sock, F_GETFL, 0);
  fcntl(sock, F_SETFL, flags | O_NONBLOCK);
  ch->fd = sock;
  ch->epfd = epoll_create1(0);
  int pipefd[2];
  if (pipe(pipefd) != 0) return -1;
  ch->wake_r = pipefd[0];
  ch->wake_w = pipefd[1];
  fcntl(ch->wake_r, F_SETFL, O_NONBLOCK);
  epoll_event ev{};
  ev.events = EPOLLIN;
  ev.data.fd = sock;
  epoll_ctl(ch->epfd, EPOLL_CTL_ADD, sock, &ev);
  epoll_event wev{};
  wev.events = EPOLLIN;
  wev.data.fd = ch->wake_r;
  epoll_ctl(ch->epfd, EPOLL_CTL_ADD, ch->wake_r, &wev);
  ch->io = std::thread([ch] { ch->io_loop(); });
  return 0;
}

}  // namespace

extern "C" {

void* td_listen(const char* host, int port) {
  int srv = socket(AF_INET, SOCK_STREAM, 0);
  if (srv < 0) return nullptr;
  int one = 1;
  setsockopt(srv, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons(static_cast<uint16_t>(port));
  inet_pton(AF_INET, host, &addr.sin_addr);
  if (bind(srv, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) != 0 ||
      listen(srv, 1) != 0) {
    close(srv);
    return nullptr;
  }
  int conn = accept(srv, nullptr, nullptr);
  close(srv);
  if (conn < 0) return nullptr;
  auto* ch = new Channel();
  if (setup_common(ch, conn) != 0) { delete ch; return nullptr; }
  return ch;
}

void* td_connect(const char* host, int port, int retries) {
  for (int i = 0; i < retries; i++) {
    int sock = socket(AF_INET, SOCK_STREAM, 0);
    if (sock < 0) return nullptr;
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_port = htons(static_cast<uint16_t>(port));
    inet_pton(AF_INET, host, &addr.sin_addr);
    if (connect(sock, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) == 0) {
      auto* ch = new Channel();
      if (setup_common(ch, sock) != 0) { delete ch; return nullptr; }
      return ch;
    }
    close(sock);
    usleep(100 * 1000);
  }
  return nullptr;
}

int td_send(void* h, const uint8_t* buf, uint32_t len) {
  auto* ch = static_cast<Channel*>(h);
  {
    std::lock_guard<std::mutex> l(ch->mu);
    if (ch->dead) return -1;
    Frame f;
    f.data.assign(buf, buf + len);
    ch->tx.push_back(std::move(f));
  }
  uint8_t b = 1;
  ::write(ch->wake_w, &b, 1);  // wake the I/O thread
  return 0;
}

long td_recv(void* h, uint8_t* buf, uint32_t cap, int timeout_ms) {
  auto* ch = static_cast<Channel*>(h);
  std::unique_lock<std::mutex> l(ch->mu);
  if (!ch->rx_cv.wait_for(l, std::chrono::milliseconds(timeout_ms),
                          [&] { return !ch->rx.empty() || ch->dead; })) {
    return 0;  // timeout
  }
  if (ch->rx.empty()) return -1;  // dead with nothing queued
  Frame& f = ch->rx.front();
  if (f.data.size() > cap) return -2;
  std::memcpy(buf, f.data.data(), f.data.size());
  long n = static_cast<long>(f.data.size());
  ch->rx.pop_front();
  return n;
}

int td_pending(void* h) {
  auto* ch = static_cast<Channel*>(h);
  std::lock_guard<std::mutex> l(ch->mu);
  return static_cast<int>(ch->rx.size());
}

uint64_t td_bytes_sent(void* h) {
  auto* ch = static_cast<Channel*>(h);
  std::lock_guard<std::mutex> l(ch->mu);
  return ch->bytes_sent;
}

uint64_t td_bytes_received(void* h) {
  auto* ch = static_cast<Channel*>(h);
  std::lock_guard<std::mutex> l(ch->mu);
  return ch->bytes_received;
}

void td_close(void* h) {
  auto* ch = static_cast<Channel*>(h);
  ch->shutdown();
  delete ch;
}

}  // extern "C"
