// Append-only CRC-framed record log — the durable op-stream shuttle.
//
// Reference parity: the native transport/storage pieces the reference
// leans on (SURVEY.md §2.9): librdkafka's partition log segments (the
// ordering bus deli consumes) and MongoDB's durable op log written by
// scriptorium (scriptorium/lambda.ts:95). One file = one partition (or
// one journal): records are [u32 len][u32 crc32][payload], little-endian,
// fsync on demand. Opening scans the file, indexes record offsets, and
// truncates a torn tail (crash mid-write recovers to the last full
// record — the Kafka segment recovery rule).
//
// Exposed as a C ABI for the Python host via ctypes
// (fluidframework_tpu_torch/native/__init__.py); the pure-Python twin in
// that module writes the identical format so files interoperate.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

#include <fcntl.h>
#include <sys/stat.h>
#include <unistd.h>
#include <zlib.h>

namespace {

struct Record {
    off_t offset;   // offset of the payload (past the 8-byte header)
    uint32_t len;
};

}  // namespace

extern "C" {

struct OpLog {
    int fd = -1;
    off_t end = 0;              // byte offset of the next append
    std::vector<Record> index;  // record payload offsets
};

OpLog* oplog_open(const char* path) {
    int fd = ::open(path, O_RDWR | O_CREAT | O_CLOEXEC, 0644);
    if (fd < 0) return nullptr;
    OpLog* log = new OpLog();
    log->fd = fd;

    struct stat st;
    if (fstat(fd, &st) != 0) {
        ::close(fd);
        delete log;
        return nullptr;
    }
    off_t size = st.st_size;
    off_t pos = 0;
    std::vector<uint8_t> buf;
    while (pos + 8 <= size) {
        uint8_t header[8];
        if (pread(fd, header, 8, pos) != 8) break;
        uint32_t len, crc;
        memcpy(&len, header, 4);
        memcpy(&crc, header + 4, 4);
        if (pos + 8 + (off_t)len > size) break;  // torn tail
        buf.resize(len);
        if (pread(fd, buf.data(), len, pos + 8) != (ssize_t)len) break;
        uint32_t actual = crc32(0L, buf.data(), len);
        if (actual != crc) break;  // corrupt/torn record: stop here
        log->index.push_back({pos + 8, len});
        pos += 8 + (off_t)len;
    }
    if (pos < size) {
        // Drop everything after the last intact record.
        if (ftruncate(fd, pos) != 0) { /* keep going; reads stay valid */ }
    }
    log->end = pos;
    return log;
}

long oplog_count(OpLog* log) {
    return log ? (long)log->index.size() : -1;
}

long oplog_append(OpLog* log, const uint8_t* data, uint32_t len) {
    if (!log || log->fd < 0) return -1;
    uint32_t crc = crc32(0L, data, len);
    uint8_t header[8];
    memcpy(header, &len, 4);
    memcpy(header + 4, &crc, 4);
    if (pwrite(log->fd, header, 8, log->end) != 8) return -1;
    if (pwrite(log->fd, data, len, log->end + 8) != (ssize_t)len) return -1;
    log->index.push_back({log->end + 8, len});
    log->end += 8 + (off_t)len;
    return (long)log->index.size() - 1;
}

// One record whose payload is the ``n`` buffers ``parts`` (``lens``
// bytes each) in order, written without joining them first: the CRC runs
// over the parts in turn and each part is written at its offset, so the
// file holds the same bytes as oplog_append of the joined payload.
long oplog_append_parts(OpLog* log, const uint8_t* const* parts,
                        const uint32_t* lens, int n) {
    if (!log || log->fd < 0 || n < 0) return -1;
    uint64_t total = 0;
    uLong crc = crc32(0L, Z_NULL, 0);
    for (int i = 0; i < n; ++i) {
        crc = crc32(crc, parts[i], lens[i]);
        total += lens[i];
    }
    if (total > UINT32_MAX) return -1;
    uint32_t len = (uint32_t)total;
    uint32_t crc32v = (uint32_t)crc;
    uint8_t header[8];
    memcpy(header, &len, 4);
    memcpy(header + 4, &crc32v, 4);
    if (pwrite(log->fd, header, 8, log->end) != 8) return -1;
    off_t at = log->end + 8;
    for (int i = 0; i < n; ++i) {
        if (pwrite(log->fd, parts[i], lens[i], at) != (ssize_t)lens[i])
            return -1;
        at += lens[i];
    }
    log->index.push_back({log->end + 8, len});
    log->end = at;
    return (long)log->index.size() - 1;
}

int oplog_sync(OpLog* log) {
    if (!log || log->fd < 0) return -1;
    return fdatasync(log->fd);
}

long oplog_read_len(OpLog* log, long i) {
    if (!log || i < 0 || (size_t)i >= log->index.size()) return -1;
    return (long)log->index[(size_t)i].len;
}

long oplog_read(OpLog* log, long i, uint8_t* out, uint32_t cap) {
    if (!log || i < 0 || (size_t)i >= log->index.size()) return -1;
    const Record& rec = log->index[(size_t)i];
    if (cap < rec.len) return -1;
    if (pread(log->fd, out, rec.len, rec.offset) != (ssize_t)rec.len)
        return -1;
    return (long)rec.len;
}

void oplog_close(OpLog* log) {
    if (!log) return;
    if (log->fd >= 0) ::close(log->fd);
    delete log;
}

}  // extern "C"
