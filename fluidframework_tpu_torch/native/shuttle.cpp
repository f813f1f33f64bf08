// In-memory partitioned op-stream shuttle with consumer-group offsets.
//
// Reference parity: SURVEY.md §2.9 — librdkafka's in-memory broker role
// between the front door and the lambda workers (topics partitioned by
// document key, per-group committed offsets, at-least-once delivery) and
// the Redis pub/sub fan-out (many groups independently consuming one
// stream). One Shuttle = one topic. Thread-safe: alfred's socket threads
// produce while pump threads consume.
//
// Records are opaque byte strings (the Python host serializes with the
// wire codec). Reads use a two-call size/fill pattern; the log is
// append-only, so a concurrent produce between the calls cannot move the
// already-sized records.
//
// Exposed as a C ABI for ctypes (native/shuttle.py);
// the pure-Python fallback is server/bus.py's MessageBus, which this
// implementation matches behavior-for-behavior (same crc32 partitioner).

#include <cstdint>
#include <cstring>
#include <map>
#include <mutex>
#include <string>
#include <vector>

#include <zlib.h>

extern "C" {

struct Shuttle {
    std::mutex mu;
    struct Partition {
        std::vector<std::string> keys;
        std::vector<std::string> payloads;
    };
    std::vector<Partition> parts;
    // "group\x00partition" -> next offset to read
    std::map<std::string, int64_t> offsets;
};

static std::string offset_key(const char* group, int partition) {
    std::string k(group);
    k.push_back('\0');
    k += std::to_string(partition);
    return k;
}

Shuttle* shuttle_create(int num_partitions) {
    if (num_partitions <= 0) return nullptr;
    Shuttle* s = new Shuttle();
    s->parts.resize((size_t)num_partitions);
    return s;
}

int shuttle_num_partitions(Shuttle* s) {
    return s ? (int)s->parts.size() : -1;
}

// Appends to the key's partition; returns the offset, with the partition
// id written to *partition_out.
int64_t shuttle_produce(Shuttle* s, const uint8_t* key, uint32_t key_len,
                        const uint8_t* payload, uint32_t payload_len,
                        int* partition_out) {
    if (!s) return -1;
    std::lock_guard<std::mutex> lock(s->mu);
    int pid = (int)(crc32(0L, key, key_len) % s->parts.size());
    auto& part = s->parts[(size_t)pid];
    part.keys.emplace_back((const char*)key, key_len);
    part.payloads.emplace_back((const char*)payload, payload_len);
    if (partition_out) *partition_out = pid;
    return (int64_t)part.keys.size() - 1;
}

int64_t shuttle_count(Shuttle* s, int partition) {
    if (!s || partition < 0 || (size_t)partition >= s->parts.size())
        return -1;
    std::lock_guard<std::mutex> lock(s->mu);
    return (int64_t)s->parts[(size_t)partition].keys.size();
}

// Size in bytes of up to max_messages records starting at from_offset,
// framed [u32 key_len][key][u32 payload_len][payload] each. max_messages
// < 0 = no limit. Returns the byte count (0 = nothing to read).
int64_t shuttle_read_size(Shuttle* s, int partition, int64_t from_offset,
                          int64_t max_messages) {
    if (!s || partition < 0 || (size_t)partition >= s->parts.size())
        return -1;
    std::lock_guard<std::mutex> lock(s->mu);
    const auto& part = s->parts[(size_t)partition];
    int64_t end = (int64_t)part.keys.size();
    if (max_messages >= 0 && from_offset + max_messages < end)
        end = from_offset + max_messages;
    int64_t total = 0;
    for (int64_t i = from_offset; i < end; i++) {
        total += 8 + (int64_t)part.keys[(size_t)i].size()
               + (int64_t)part.payloads[(size_t)i].size();
    }
    return total;
}

// Fills out with the frames sized by shuttle_read_size; returns the
// number of RECORDS written (-1 on under-sized buffer).
int64_t shuttle_read(Shuttle* s, int partition, int64_t from_offset,
                     int64_t max_messages, uint8_t* out, int64_t cap) {
    if (!s || partition < 0 || (size_t)partition >= s->parts.size())
        return -1;
    std::lock_guard<std::mutex> lock(s->mu);
    const auto& part = s->parts[(size_t)partition];
    int64_t end = (int64_t)part.keys.size();
    if (max_messages >= 0 && from_offset + max_messages < end)
        end = from_offset + max_messages;
    int64_t pos = 0, count = 0;
    for (int64_t i = from_offset; i < end; i++) {
        const auto& key = part.keys[(size_t)i];
        const auto& payload = part.payloads[(size_t)i];
        int64_t need = 8 + (int64_t)key.size() + (int64_t)payload.size();
        if (pos + need > cap) return -1;
        uint32_t klen = (uint32_t)key.size();
        uint32_t plen = (uint32_t)payload.size();
        memcpy(out + pos, &klen, 4); pos += 4;
        memcpy(out + pos, key.data(), klen); pos += klen;
        memcpy(out + pos, &plen, 4); pos += 4;
        memcpy(out + pos, payload.data(), plen); pos += plen;
        count++;
    }
    return count;
}

int64_t shuttle_committed(Shuttle* s, const char* group, int partition) {
    if (!s) return -1;
    std::lock_guard<std::mutex> lock(s->mu);
    auto it = s->offsets.find(offset_key(group, partition));
    return it == s->offsets.end() ? 0 : it->second;
}

int shuttle_commit(Shuttle* s, const char* group, int partition,
                   int64_t next_offset) {
    if (!s) return -1;
    std::lock_guard<std::mutex> lock(s->mu);
    s->offsets[offset_key(group, partition)] = next_offset;
    return 0;
}

void shuttle_destroy(Shuttle* s) {
    delete s;
}

}  // extern "C"
