// Fan-out service — native pub/sub rooms with per-subscriber queues.
//
// Reference parity: the broadcast fan-out hop of the reference server —
// Redis pub/sub + the socket.io Redis adapter
// (server/routerlicious/packages/services-shared/src/
// redisSocketIoAdapter.ts; services/package.json ioredis) — the native
// (C) piece between the broadcaster lambda and the socket frontends
// (SURVEY.md §2.9 row 3). Rooms are documents; a publish appends the
// payload to every member's queue; frontends drain their subscriber
// queue and write to their transport.
//
// Exposed as a C ABI for ctypes (fanout.py). All calls are thread-safe
// behind one mutex — the workload is many small payloads, and the
// Python callers hold the GIL around calls anyway; contention is nil.

#include <cstdint>
#include <cstring>
#include <deque>
#include <map>
#include <memory>
#include <set>
#include <string>
#include <mutex>
#include <vector>

namespace {

// Slow-consumer bound: a subscriber that never polls is evicted once
// this many payloads queue up (the socket.io Redis adapter analog drops
// slow clients rather than buffering without bound). Per-subscriber
// overrides (fanout_set_queue_limit) let a connection CLASS pick a
// different bound — read-only viewers lag-drop at a shallow queue while
// writer subscribers keep the deep default.
constexpr size_t kMaxQueue = 65536;

// Queue entries are shared: a publish to a 100k-member room allocates
// the payload ONCE and every member queues a refcounted pointer, so the
// broadcast hop is O(members) pointer pushes, not O(members) copies.
using Payload = std::shared_ptr<const std::string>;

struct Fanout {
    std::mutex mu;
    int64_t next_sub = 1;
    int64_t delivered = 0;
    std::map<int64_t, std::deque<Payload>> queues;
    std::map<std::string, std::set<int64_t>> rooms;
    std::map<int64_t, std::set<std::string>> memberships;
    std::map<int64_t, size_t> limits;  // per-sub override; absent = kMaxQueue
    std::set<int64_t> evicted;
};

// Caller holds f->mu.
size_t limit_for(Fanout* f, int64_t sub) {
    auto it = f->limits.find(sub);
    return it == f->limits.end() ? kMaxQueue : it->second;
}

// Caller holds f->mu.
void drop_subscriber(Fanout* f, int64_t sub) {
    auto member_it = f->memberships.find(sub);
    if (member_it != f->memberships.end()) {
        for (const std::string& room : member_it->second) {
            auto room_it = f->rooms.find(room);
            if (room_it != f->rooms.end()) {
                room_it->second.erase(sub);
                if (room_it->second.empty()) f->rooms.erase(room_it);
            }
        }
        f->memberships.erase(member_it);
    }
    f->queues.erase(sub);
    f->limits.erase(sub);
}

// Caller holds f->mu. Returns queues appended (the publish body shared
// by fanout_publish and fanout_publish_batch).
int64_t publish_locked(Fanout* f, const std::string& room,
                       const char* data, uint32_t data_len) {
    auto room_it = f->rooms.find(room);
    if (room_it == f->rooms.end()) return 0;
    Payload payload = std::make_shared<const std::string>(data, data_len);
    int64_t count = 0;
    std::vector<int64_t> over;
    for (int64_t sub : room_it->second) {
        auto queue_it = f->queues.find(sub);
        if (queue_it == f->queues.end()) continue;
        if (queue_it->second.size() >= limit_for(f, sub)) {
            over.push_back(sub);
            continue;
        }
        queue_it->second.push_back(payload);
        ++count;
    }
    for (int64_t sub : over) {
        drop_subscriber(f, sub);
        f->evicted.insert(sub);
    }
    f->delivered += count;
    return count;
}

}  // namespace

extern "C" {

void* fanout_create() { return new Fanout(); }

void fanout_destroy(void* handle) { delete static_cast<Fanout*>(handle); }

int64_t fanout_connect(void* handle) {
    Fanout* f = static_cast<Fanout*>(handle);
    std::lock_guard<std::mutex> lock(f->mu);
    int64_t sub = f->next_sub++;
    f->queues[sub];  // create the queue
    return sub;
}

int fanout_disconnect(void* handle, int64_t sub) {
    Fanout* f = static_cast<Fanout*>(handle);
    std::lock_guard<std::mutex> lock(f->mu);
    // An evicted sub's queue is already gone; its disconnect must still
    // succeed and clear the eviction flag (else the set grows forever).
    bool was_evicted = f->evicted.erase(sub) > 0;
    if (f->queues.find(sub) == f->queues.end())
        return was_evicted ? 0 : -1;
    drop_subscriber(f, sub);
    return 0;
}

int fanout_join(void* handle, int64_t sub, const char* room,
                uint32_t room_len) {
    Fanout* f = static_cast<Fanout*>(handle);
    std::lock_guard<std::mutex> lock(f->mu);
    if (f->queues.find(sub) == f->queues.end()) return -1;
    std::string key(room, room_len);
    f->rooms[key].insert(sub);
    f->memberships[sub].insert(key);
    return 0;
}

int fanout_leave(void* handle, int64_t sub, const char* room,
                 uint32_t room_len) {
    Fanout* f = static_cast<Fanout*>(handle);
    std::lock_guard<std::mutex> lock(f->mu);
    std::string key(room, room_len);
    auto room_it = f->rooms.find(key);
    if (room_it == f->rooms.end() || room_it->second.erase(sub) == 0)
        return -1;
    if (room_it->second.empty()) f->rooms.erase(room_it);
    f->memberships[sub].erase(key);
    return 0;
}

// Returns the number of subscriber queues the payload was appended to.
int64_t fanout_publish(void* handle, const char* room, uint32_t room_len,
                       const char* data, uint32_t data_len) {
    Fanout* f = static_cast<Fanout*>(handle);
    std::lock_guard<std::mutex> lock(f->mu);
    return publish_locked(f, std::string(room, room_len), data, data_len);
}

// Batched publish — ONE native call + one lock for a whole serving
// tick's broadcasts (the storm harvest's per-doc fan-out hop). ``buf``
// holds ``n`` records of [u32 room_len][room][u32 data_len][data].
// Returns total deliveries across records, -1 on a malformed buffer.
int64_t fanout_publish_batch(void* handle, const char* buf, int64_t len,
                             int64_t n) {
    Fanout* f = static_cast<Fanout*>(handle);
    std::lock_guard<std::mutex> lock(f->mu);
    const char* p = buf;
    const char* end = buf + len;
    int64_t total = 0;
    for (int64_t i = 0; i < n; ++i) {
        uint32_t room_len, data_len;
        if (p + 4 > end) return -1;
        std::memcpy(&room_len, p, 4);
        p += 4;
        if (p + room_len + 4 > end) return -1;
        std::string room(p, room_len);
        p += room_len;
        std::memcpy(&data_len, p, 4);
        p += 4;
        if (p + data_len > end) return -1;
        total += publish_locked(f, room, p, data_len);
        p += data_len;
    }
    return total;
}

// 1 if the subscriber was dropped for slow consumption, else 0.
int fanout_was_evicted(void* handle, int64_t sub) {
    Fanout* f = static_cast<Fanout*>(handle);
    std::lock_guard<std::mutex> lock(f->mu);
    return f->evicted.count(sub) ? 1 : 0;
}

int64_t fanout_pending(void* handle, int64_t sub) {
    Fanout* f = static_cast<Fanout*>(handle);
    std::lock_guard<std::mutex> lock(f->mu);
    auto queue_it = f->queues.find(sub);
    if (queue_it == f->queues.end()) return -1;
    return static_cast<int64_t>(queue_it->second.size());
}

// Size in bytes of the head message (may be 0: empty payloads are
// legal); -1 = unknown sub, -2 = empty queue.
int64_t fanout_next_size(void* handle, int64_t sub) {
    Fanout* f = static_cast<Fanout*>(handle);
    std::lock_guard<std::mutex> lock(f->mu);
    auto queue_it = f->queues.find(sub);
    if (queue_it == f->queues.end()) return -1;
    if (queue_it->second.empty()) return -2;
    return static_cast<int64_t>(queue_it->second.front()->size());
}

// Pops the head message into buf. Returns bytes written (may be 0),
// -1 on unknown sub, -2 if the buffer is too small (message stays),
// -3 on empty queue.
int64_t fanout_poll(void* handle, int64_t sub, char* buf, int64_t cap) {
    Fanout* f = static_cast<Fanout*>(handle);
    std::lock_guard<std::mutex> lock(f->mu);
    auto queue_it = f->queues.find(sub);
    if (queue_it == f->queues.end()) return -1;
    if (queue_it->second.empty()) return -3;
    const std::string& head = *queue_it->second.front();
    if (static_cast<int64_t>(head.size()) > cap) return -2;
    std::memcpy(buf, head.data(), head.size());
    int64_t written = static_cast<int64_t>(head.size());
    queue_it->second.pop_front();
    return written;
}

int64_t fanout_delivered_total(void* handle) {
    Fanout* f = static_cast<Fanout*>(handle);
    std::lock_guard<std::mutex> lock(f->mu);
    return f->delivered;
}

// Batched drain — ONE native call pops the head message of up to n
// subscribers (the 100k-viewer frontend drain; per-subscriber FFI was
// the dominant cost of a big room's delivery loop). Payloads pack
// contiguously into buf in subscriber order; lens[i] = payload length,
// -1 = empty queue, -2 = unknown subscriber (disconnected or evicted —
// the caller runs its slow-consumer policy). Returns total bytes
// written, or -(needed) when cap is too small — nothing is popped in
// that case, so the caller simply retries with a bigger buffer.
int64_t fanout_poll_batch(void* handle, const int64_t* subs, int64_t n,
                          char* buf, int64_t cap, int64_t* lens) {
    Fanout* f = static_cast<Fanout*>(handle);
    std::lock_guard<std::mutex> lock(f->mu);
    int64_t needed = 0;
    for (int64_t i = 0; i < n; ++i) {
        auto it = f->queues.find(subs[i]);
        if (it != f->queues.end() && !it->second.empty())
            needed += static_cast<int64_t>(it->second.front()->size());
    }
    if (needed > cap) return -needed;
    int64_t off = 0;
    for (int64_t i = 0; i < n; ++i) {
        auto it = f->queues.find(subs[i]);
        if (it == f->queues.end()) {
            lens[i] = -2;
            continue;
        }
        if (it->second.empty()) {
            lens[i] = -1;
            continue;
        }
        const std::string& head = *it->second.front();
        if (off + static_cast<int64_t>(head.size()) > cap) {
            // Unreachable for unique sub ids (the pre-scan sized cap),
            // but a duplicated id pops SUCCESSIVE entries whose sizes
            // the scan never saw — leave the message queued for the
            // next call rather than overflow the caller's buffer.
            lens[i] = -1;
            continue;
        }
        std::memcpy(buf + off, head.data(), head.size());
        lens[i] = static_cast<int64_t>(head.size());
        off += lens[i];
        it->second.pop_front();
    }
    return off;
}

// Per-subscriber queue bound override (n <= 0 restores the default):
// the slow-consumer eviction point becomes a per-connection-class
// policy — viewer subscribers lag-drop shallow, writers keep the
// default depth.
int fanout_set_queue_limit(void* handle, int64_t sub, int64_t n) {
    Fanout* f = static_cast<Fanout*>(handle);
    std::lock_guard<std::mutex> lock(f->mu);
    if (f->queues.find(sub) == f->queues.end()) return -1;
    if (n <= 0)
        f->limits.erase(sub);
    else
        f->limits[sub] = static_cast<size_t>(n);
    return 0;
}

// Members of a room (0 for unknown/reclaimed rooms — an empty room is
// erased, so "absent" and "empty" are the same observable state).
int64_t fanout_room_size(void* handle, const char* room,
                         uint32_t room_len) {
    Fanout* f = static_cast<Fanout*>(handle);
    std::lock_guard<std::mutex> lock(f->mu);
    auto it = f->rooms.find(std::string(room, room_len));
    if (it == f->rooms.end()) return 0;
    return static_cast<int64_t>(it->second.size());
}

// Live (non-empty) rooms — the monitor's rooms gauge; also the
// empty-room-reclamation observable (a fully-left room must not linger).
int64_t fanout_room_count(void* handle) {
    Fanout* f = static_cast<Fanout*>(handle);
    std::lock_guard<std::mutex> lock(f->mu);
    return static_cast<int64_t>(f->rooms.size());
}

}  // extern "C"
