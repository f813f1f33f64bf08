// Front-door socket bridge — native framed-TCP transport.
//
// Reference parity: the native transport layer under the reference's
// front door — Node's libuv socket machinery + socket.io/ws native
// addons carrying alfred's connections (alfred/index.ts:343,
// driver-base documentDeltaConnection.ts:35) — and SURVEY.md §2.9/§5.8's
// "C++ streaming bridge between the front door and the TPU host": the
// DCN hop is owned by native code; Python only sees whole decoded
// frames.
//
// Protocol: the same length-prefixed framing alfred speaks (4-byte BE
// length + body), so the existing network driver connects to this
// bridge unchanged. The C++ side owns accept/read/write threads and
// per-connection outboxes; the host pumps events:
//
//   bridge_start(port) -> handle          bridge_port(handle)
//   bridge_next_size(handle)              size of next event payload
//   bridge_poll_wait(handle, timeout_ms)  block until an event is queued;
//       returns its size, or -3 on timeout (cv wait, no busy polling)
//   bridge_poll(handle, buf, cap)         -> [conn:8B][kind:4B][body...]
//       kind: 0 = OPEN, 1 = DATA (body = one frame), 2 = CLOSE
//   bridge_send(handle, conn, data, len)  enqueue one framed body
//       (0 ok, -1 unknown/closing, -2 outbox full — caller should close)
//   bridge_set_max_outbox(handle, n)      tune the -2 threshold
//   bridge_set_conn_max_outbox(handle, conn, n)  per-connection override
//       (connection classes: viewers shallow, writers default)
//   bridge_close(handle, conn)            server-side disconnect
//   bridge_stop(handle)
//
// Backpressure: a connection whose decoded frames pile up faster than
// the host pump drains them (kMaxInboundQueue) is dropped, and a peer
// that stops reading until kMaxOutbox responses queue up gets -2 from
// bridge_send — mirroring socket.io/Redis adapter slow-consumer drops;
// kMaxFrame alone only bounds a single frame.
//
// Exposed as a C ABI for ctypes (bridge.py).

#include <arpa/inet.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <unistd.h>

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <map>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr uint32_t kMaxFrame = 64u * 1024u * 1024u;
constexpr size_t kMaxInboundQueue = 8192;  // decoded frames per conn
constexpr size_t kMaxOutbox = 8192;        // queued responses per conn

struct Event {
    int64_t conn;
    int32_t kind;  // 0 open, 1 data, 2 close
    std::string body;
};

struct Conn {
    int fd = -1;
    std::thread reader;
    std::thread writer;
    std::mutex out_mu;
    std::condition_variable out_cv;
    std::deque<std::string> outbox;
    // Per-connection outbox bound; 0 = use the bridge-wide default.
    // Lets connection CLASSES differ (a read-only viewer lag-drops at a
    // shallow outbox while writer connections keep the deep default).
    size_t max_outbox = 0;
    bool closing = false;
};

struct Bridge {
    int listen_fd = -1;
    int port = 0;
    // Outbox bound (kMaxOutbox default); tunable so hosts/tests can pick
    // the point where a stalled reader trips -2 instead of buffering on.
    std::atomic<size_t> max_outbox{kMaxOutbox};
    std::atomic<bool> stopping{false};
    std::thread acceptor;
    std::mutex mu;  // guards conns, events, inbound_depth
    std::condition_variable events_cv;
    std::map<int64_t, std::unique_ptr<Conn>> conns;
    int64_t next_conn = 1;
    std::deque<Event> events;
    std::map<int64_t, size_t> inbound_depth;  // queued DATA events per conn
    // Detached per-close reapers; stop() waits for the count to drain
    // before freeing the Bridge (their Conn readers touch b->events).
    std::mutex reap_mu;
    std::condition_variable reap_cv;
    int live_reapers = 0;
};

bool read_exact(int fd, char* buf, size_t n) {
    size_t got = 0;
    while (got < n) {
        ssize_t r = ::recv(fd, buf + got, n - got, 0);
        if (r <= 0) return false;
        got += static_cast<size_t>(r);
    }
    return true;
}

bool write_all(int fd, const char* buf, size_t n) {
    size_t sent = 0;
    while (sent < n) {
        ssize_t r = ::send(fd, buf + sent, n - sent, MSG_NOSIGNAL);
        if (r <= 0) return false;
        sent += static_cast<size_t>(r);
    }
    return true;
}

void reader_loop(Bridge* b, int64_t id, int fd) {
    for (;;) {
        char header[4];
        if (!read_exact(fd, header, 4)) break;
        uint32_t len = (static_cast<uint8_t>(header[0]) << 24)
                       | (static_cast<uint8_t>(header[1]) << 16)
                       | (static_cast<uint8_t>(header[2]) << 8)
                       | static_cast<uint8_t>(header[3]);
        if (len > kMaxFrame) break;
        std::string body(len, '\0');
        if (len && !read_exact(fd, &body[0], len)) break;
        {
            std::lock_guard<std::mutex> lock(b->mu);
            // Backpressure: drop the connection rather than buffer a
            // sender that outruns the pump without bound.
            if (b->inbound_depth[id] >= kMaxInboundQueue) break;
            ++b->inbound_depth[id];
            b->events.push_back(Event{id, 1, std::move(body)});
        }
        b->events_cv.notify_one();
    }
    {
        std::lock_guard<std::mutex> lock(b->mu);
        b->events.push_back(Event{id, 2, std::string()});
    }
    b->events_cv.notify_one();
}

void writer_loop(Conn* c) {
    for (;;) {
        std::string body;
        {
            std::unique_lock<std::mutex> lock(c->out_mu);
            c->out_cv.wait(lock, [c] {
                return c->closing || !c->outbox.empty();
            });
            if (c->outbox.empty()) return;  // closing with nothing queued
            body = std::move(c->outbox.front());
            c->outbox.pop_front();
        }
        char header[4] = {
            static_cast<char>((body.size() >> 24) & 0xFF),
            static_cast<char>((body.size() >> 16) & 0xFF),
            static_cast<char>((body.size() >> 8) & 0xFF),
            static_cast<char>(body.size() & 0xFF),
        };
        if (!write_all(c->fd, header, 4)) return;
        if (!body.empty() && !write_all(c->fd, body.data(), body.size()))
            return;
    }
}

void accept_loop(Bridge* b) {
    while (!b->stopping.load()) {
        int fd = ::accept(b->listen_fd, nullptr, nullptr);
        if (fd < 0) {
            if (b->stopping.load()) return;
            // EMFILE etc.: back off instead of spinning a core.
            std::this_thread::sleep_for(std::chrono::milliseconds(10));
            continue;
        }
        int one = 1;
        ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
        auto conn = std::make_unique<Conn>();
        conn->fd = fd;
        Conn* raw = conn.get();
        std::lock_guard<std::mutex> lock(b->mu);
        int64_t id = b->next_conn++;
        raw->reader = std::thread(reader_loop, b, id, fd);
        raw->writer = std::thread(writer_loop, raw);
        b->conns[id] = std::move(conn);
        b->events.push_back(Event{id, 0, std::string()});
        b->events_cv.notify_one();
    }
}

void shutdown_conn(Conn* c) {
    {
        std::lock_guard<std::mutex> lock(c->out_mu);
        c->closing = true;
    }
    c->out_cv.notify_all();
    ::shutdown(c->fd, SHUT_RDWR);
    if (c->writer.joinable()) c->writer.join();
    if (c->reader.joinable()) c->reader.join();
    ::close(c->fd);
}

}  // namespace

extern "C" {

void* bridge_start(int port) {
    auto b = std::make_unique<Bridge>();
    b->listen_fd = ::socket(AF_INET, SOCK_STREAM, 0);
    if (b->listen_fd < 0) return nullptr;
    int one = 1;
    ::setsockopt(b->listen_fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_addr.s_addr = htonl(INADDR_LOOPBACK);
    addr.sin_port = htons(static_cast<uint16_t>(port));
    if (::bind(b->listen_fd, reinterpret_cast<sockaddr*>(&addr),
               sizeof(addr)) != 0
        || ::listen(b->listen_fd, 64) != 0) {
        ::close(b->listen_fd);
        return nullptr;
    }
    socklen_t len = sizeof(addr);
    ::getsockname(b->listen_fd, reinterpret_cast<sockaddr*>(&addr), &len);
    b->port = ntohs(addr.sin_port);
    b->acceptor = std::thread(accept_loop, b.get());
    return b.release();
}

int bridge_port(void* handle) {
    return static_cast<Bridge*>(handle)->port;
}

int64_t bridge_next_size(void* handle) {
    Bridge* b = static_cast<Bridge*>(handle);
    std::lock_guard<std::mutex> lock(b->mu);
    if (b->events.empty()) return -3;
    return static_cast<int64_t>(12 + b->events.front().body.size());
}

int64_t bridge_poll_wait(void* handle, int timeout_ms) {
    Bridge* b = static_cast<Bridge*>(handle);
    std::unique_lock<std::mutex> lock(b->mu);
    b->events_cv.wait_for(lock, std::chrono::milliseconds(timeout_ms),
                          [b] { return !b->events.empty(); });
    if (b->events.empty()) return -3;
    return static_cast<int64_t>(12 + b->events.front().body.size());
}

int64_t bridge_poll(void* handle, char* buf, int64_t cap) {
    Bridge* b = static_cast<Bridge*>(handle);
    std::lock_guard<std::mutex> lock(b->mu);
    if (b->events.empty()) return -3;
    Event& event = b->events.front();
    int64_t need = static_cast<int64_t>(12 + event.body.size());
    if (need > cap) return -2;
    std::memcpy(buf, &event.conn, 8);
    std::memcpy(buf + 8, &event.kind, 4);
    if (!event.body.empty())
        std::memcpy(buf + 12, event.body.data(), event.body.size());
    if (event.kind == 1) {
        auto depth = b->inbound_depth.find(event.conn);
        if (depth != b->inbound_depth.end() && depth->second > 0)
            --depth->second;
    } else if (event.kind == 2) {
        b->inbound_depth.erase(event.conn);
    }
    b->events.pop_front();
    return need;
}

int bridge_send(void* handle, int64_t conn, const char* data,
                uint32_t len) {
    Bridge* b = static_cast<Bridge*>(handle);
    std::lock_guard<std::mutex> lock(b->mu);
    auto it = b->conns.find(conn);
    if (it == b->conns.end()) return -1;
    Conn* c = it->second.get();
    {
        std::lock_guard<std::mutex> out_lock(c->out_mu);
        if (c->closing) return -1;
        size_t limit = c->max_outbox ? c->max_outbox
                                     : b->max_outbox.load();
        if (c->outbox.size() >= limit) return -2;
        c->outbox.emplace_back(data, len);
    }
    c->out_cv.notify_one();
    return 0;
}

void bridge_set_max_outbox(void* handle, int64_t n) {
    if (n > 0)
        static_cast<Bridge*>(handle)->max_outbox.store(
            static_cast<size_t>(n));
}

// Per-connection override of the -2 threshold (n <= 0 restores the
// bridge default). Returns 0, or -1 for an unknown connection.
int bridge_set_conn_max_outbox(void* handle, int64_t conn, int64_t n) {
    Bridge* b = static_cast<Bridge*>(handle);
    std::lock_guard<std::mutex> lock(b->mu);
    auto it = b->conns.find(conn);
    if (it == b->conns.end()) return -1;
    Conn* c = it->second.get();
    std::lock_guard<std::mutex> out_lock(c->out_mu);
    c->max_outbox = n > 0 ? static_cast<size_t>(n) : 0;
    return 0;
}

int bridge_close(void* handle, int64_t conn) {
    Bridge* b = static_cast<Bridge*>(handle);
    std::unique_ptr<Conn> owned;
    {
        std::lock_guard<std::mutex> lock(b->mu);
        auto it = b->conns.find(conn);
        if (it == b->conns.end()) return -1;
        owned = std::move(it->second);
        b->conns.erase(it);
    }
    // Joining reader/writer can block on in-flight IO; do it off the
    // caller's thread (detached) so the Python pump never stalls and no
    // unjoined thread accumulates per disconnect.
    Conn* craw = owned.release();
    {
        std::lock_guard<std::mutex> lock(b->reap_mu);
        ++b->live_reapers;
    }
    std::thread([b, craw] {
        shutdown_conn(craw);
        delete craw;
        {
            std::lock_guard<std::mutex> lock(b->reap_mu);
            --b->live_reapers;
        }
        b->reap_cv.notify_all();
    }).detach();
    return 0;
}

void bridge_stop(void* handle) {
    Bridge* b = static_cast<Bridge*>(handle);
    b->stopping.store(true);
    ::shutdown(b->listen_fd, SHUT_RDWR);
    ::close(b->listen_fd);
    if (b->acceptor.joinable()) b->acceptor.join();
    std::map<int64_t, std::unique_ptr<Conn>> conns;
    {
        std::lock_guard<std::mutex> lock(b->mu);
        conns.swap(b->conns);
    }
    for (auto& entry : conns) shutdown_conn(entry.second.get());
    {
        std::unique_lock<std::mutex> lock(b->reap_mu);
        b->reap_cv.wait(lock, [b] { return b->live_reapers == 0; });
    }
    delete b;
}

}  // extern "C"
