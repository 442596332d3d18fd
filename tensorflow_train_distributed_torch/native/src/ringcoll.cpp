// Host-side TCP ring collectives: chunked ring allreduce + ring broadcast.
//
// The PyTorch port's copy of the JAX package's native ring (built from
// this file by tensorflow_train_distributed_torch/native/__init__.py).
// It answers the reference's CPU/DCN collective path (SURVEY.md §2.3:
// `RingAlg`/`RingReducer`, `core/common_runtime/ring_alg.h:32`,
// `ring_reducer.h:32`): device-side collectives run over NCCL, but
// host-side coordination data (metrics fan-in, data-pipeline
// bookkeeping, test backends without a device fabric) still wants a ring
// over plain sockets. Classic two-phase algorithm: reduce-scatter then
// all-gather, W-1 steps each, with send-to-next/recv-from-prev overlapped
// via a sender thread per step. Bandwidth-optimal 2·(W-1)/W · N bytes on
// the wire per rank.
//
// C ABI for ctypes. Blocking, single in-flight collective per ring — the
// caller provides ordering (matches how the framework serializes host
// collectives; the device collectives keep their own order).

#include <arpa/inet.h>
#include <fcntl.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <poll.h>
#include <sys/socket.h>
#include <unistd.h>

#include <cerrno>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <ctime>
#include <string>
#include <vector>

namespace {

// Sockets are nonblocking (full-duplex Exchange needs it); the *All
// helpers poll on EAGAIN so they present a blocking interface.
bool SendAll(int fd, const void* data, size_t n) {
  const char* p = static_cast<const char*>(data);
  while (n > 0) {
    ssize_t k = ::send(fd, p, n, MSG_NOSIGNAL);
    if (k < 0) {
      if (errno == EINTR) continue;
      if (errno == EAGAIN || errno == EWOULDBLOCK) {
        pollfd pf{fd, POLLOUT, 0};
        ::poll(&pf, 1, -1);
        continue;
      }
      return false;
    }
    if (k == 0) return false;
    p += k;
    n -= static_cast<size_t>(k);
  }
  return true;
}

bool RecvAll(int fd, void* data, size_t n) {
  char* p = static_cast<char*>(data);
  while (n > 0) {
    ssize_t k = ::recv(fd, p, n, 0);
    if (k < 0) {
      if (errno == EINTR) continue;
      if (errno == EAGAIN || errno == EWOULDBLOCK) {
        pollfd pf{fd, POLLIN, 0};
        ::poll(&pf, 1, -1);
        continue;
      }
      return false;
    }
    if (k == 0) return false;  // peer closed
    p += k;
    n -= static_cast<size_t>(k);
  }
  return true;
}

class Ring {
 public:
  // peers: "host:port" per rank, comma-separated, rank-ordered.
  // Topology: rank r accepts a connection from r-1 and connects to r+1.
  static Ring* Create(int rank, int world, const std::string& peers,
                      int timeout_ms);

  ~Ring() {
    if (send_fd_ >= 0) ::close(send_fd_);
    if (recv_fd_ >= 0) ::close(recv_fd_);
    if (listen_fd_ >= 0) ::close(listen_fd_);
  }

  // In-place sum-allreduce of n floats. Returns 0 on success.
  int AllreduceF32(float* data, uint64_t n) {
    if (world_ == 1) return 0;
    const uint64_t chunks = static_cast<uint64_t>(world_);
    std::vector<uint64_t> ofs(chunks + 1);
    for (uint64_t c = 0; c <= chunks; ++c) ofs[c] = n * c / chunks;
    std::vector<float> inbox(ofs[1] - ofs[0] + n / chunks + 2);

    // Phase 1 — reduce-scatter: after W-1 steps, chunk (r+1)%W on rank r
    // holds the full sum.
    for (int step = 0; step < world_ - 1; ++step) {
      uint64_t sc = (rank_ - step + 2 * world_) % world_;        // send
      uint64_t rc = (rank_ - step - 1 + 2 * world_) % world_;    // recv
      if (!Exchange(data + ofs[sc], (ofs[sc + 1] - ofs[sc]) * 4,
                    inbox.data(), (ofs[rc + 1] - ofs[rc]) * 4))
        return -1;
      float* dst = data + ofs[rc];
      const uint64_t m = ofs[rc + 1] - ofs[rc];
      for (uint64_t i = 0; i < m; ++i) dst[i] += inbox[i];
    }
    // Phase 2 — all-gather the reduced chunks around the ring.
    for (int step = 0; step < world_ - 1; ++step) {
      uint64_t sc = (rank_ + 1 - step + 2 * world_) % world_;
      uint64_t rc = (rank_ - step + 2 * world_) % world_;
      if (!Exchange(data + ofs[sc], (ofs[sc + 1] - ofs[sc]) * 4,
                    data + ofs[rc], (ofs[rc + 1] - ofs[rc]) * 4))
        return -1;
    }
    return 0;
  }

  // Quantized ring allreduce (EQuARX-style, PAPERS.md: "Efficient
  // Quantized AllReduce in XLA"): int8 blocks with a shared f32 scale
  // on the wire — ~4x less traffic than f32 at block 512, the lever
  // for the bandwidth-scarce host/DCN path this ring serves.
  //
  // Wire format per block of up to kQBlock floats: [f32 scale][int8 xB].
  // Phase 1 (reduce-scatter) re-quantizes each hop's PARTIAL sums —
  // error grows with hops, bounded by sum of per-hop scale/2 (~(W-1) *
  // max|partial| / 254 per element).  Phase 2 (all-gather) quantizes
  // each reduced chunk ONCE at its owner and forwards the wire bytes
  // verbatim, so every rank dequantizes identical bytes — the
  // allreduce stays BIT-CONSISTENT across ranks (the property device
  // collectives guarantee and metric fan-in relies on); the owner also
  // replaces its exact f32 chunk with the dequantized wire values.
  static constexpr uint64_t kQBlock = 512;

  static uint64_t QBytes(uint64_t m) {
    return m + 4 * ((m + kQBlock - 1) / kQBlock);
  }

  static void QuantizeBlocks(const float* src, uint64_t m, uint8_t* wire) {
    for (uint64_t b0 = 0; b0 < m; b0 += kQBlock) {
      const uint64_t bl = (m - b0 < kQBlock) ? (m - b0) : kQBlock;
      float amax = 0.f;
      for (uint64_t i = 0; i < bl; ++i) {
        float a = std::fabs(src[b0 + i]);
        if (a > amax) amax = a;
      }
      // Guard on the DERIVED values, not amax: a subnormal amax gives
      // scale==0 / inv==inf (then 0*inf = NaN and lrintf(NaN) is UB),
      // and a non-finite amax (inf/NaN input) does the same.  Fall back
      // to scale 1 — tiny values quantize to 0 (within their error
      // bound) and non-finite inputs saturate to +/-127 deliberately
      // (an approximate allreduce cannot carry the NaN signal exactly;
      // callers needing NaN propagation use the exact AllreduceF32).
      float scale = amax / 127.f;
      float inv = 1.f / scale;
      if (!(scale > 0.f) || !std::isfinite(inv) || !std::isfinite(scale)) {
        scale = 1.f;
        inv = 1.f;
      }
      std::memcpy(wire, &scale, 4);
      int8_t* q = reinterpret_cast<int8_t*>(wire + 4);
      for (uint64_t i = 0; i < bl; ++i) {
        float v = src[b0 + i] * inv;
        // NaN-safe clamp: comparisons with NaN are false, so order the
        // branches to land on 0 for NaN rather than fall through lrintf.
        if (v > 127.f) v = 127.f;
        else if (v < -127.f) v = -127.f;
        else if (!(v >= -127.f && v <= 127.f)) v = 0.f;  // NaN
        q[i] = static_cast<int8_t>(std::lrintf(v));
      }
      wire += 4 + bl;
    }
  }

  // dst op= dequant(wire): Add accumulates, Copy overwrites.
  template <bool kAdd>
  static void DequantInto(const uint8_t* wire, uint64_t m, float* dst) {
    for (uint64_t b0 = 0; b0 < m; b0 += kQBlock) {
      const uint64_t bl = (m - b0 < kQBlock) ? (m - b0) : kQBlock;
      float scale;
      std::memcpy(&scale, wire, 4);
      const int8_t* q = reinterpret_cast<const int8_t*>(wire + 4);
      for (uint64_t i = 0; i < bl; ++i) {
        const float v = static_cast<float>(q[i]) * scale;
        if (kAdd) dst[b0 + i] += v; else dst[b0 + i] = v;
      }
      wire += 4 + bl;
    }
  }

  int AllreduceQ8F32(float* data, uint64_t n) {
    if (world_ == 1) return 0;
    const uint64_t chunks = static_cast<uint64_t>(world_);
    std::vector<uint64_t> ofs(chunks + 1);
    for (uint64_t c = 0; c <= chunks; ++c) ofs[c] = n * c / chunks;
    // Whole-tensor wire buffer, chunk-addressable (phase 2 forwards
    // received chunks verbatim from it).
    std::vector<uint64_t> wofs(chunks + 1);
    wofs[0] = 0;
    for (uint64_t c = 0; c < chunks; ++c)
      wofs[c + 1] = wofs[c] + QBytes(ofs[c + 1] - ofs[c]);
    std::vector<uint8_t> wire(wofs[chunks]);
    std::vector<uint8_t> sendbuf(QBytes(n / chunks + n % chunks + 1));

    // Phase 1 — reduce-scatter with per-hop requantization.
    for (int step = 0; step < world_ - 1; ++step) {
      uint64_t sc = (rank_ - step + 2 * world_) % world_;
      uint64_t rc = (rank_ - step - 1 + 2 * world_) % world_;
      const uint64_t sm = ofs[sc + 1] - ofs[sc];
      const uint64_t rm = ofs[rc + 1] - ofs[rc];
      QuantizeBlocks(data + ofs[sc], sm, sendbuf.data());
      if (!Exchange(sendbuf.data(), QBytes(sm),
                    wire.data() + wofs[rc], QBytes(rm)))
        return -1;
      DequantInto<true>(wire.data() + wofs[rc], rm, data + ofs[rc]);
    }
    // Phase 2 — all-gather: own reduced chunk quantized ONCE, then
    // wire bytes forwarded verbatim (bit-consistency across ranks).
    {
      const uint64_t oc = (rank_ + 1) % world_;
      const uint64_t om = ofs[oc + 1] - ofs[oc];
      QuantizeBlocks(data + ofs[oc], om, wire.data() + wofs[oc]);
      DequantInto<false>(wire.data() + wofs[oc], om, data + ofs[oc]);
    }
    for (int step = 0; step < world_ - 1; ++step) {
      uint64_t sc = (rank_ + 1 - step + 2 * world_) % world_;
      uint64_t rc = (rank_ - step + 2 * world_) % world_;
      const uint64_t sm = ofs[sc + 1] - ofs[sc];
      const uint64_t rm = ofs[rc + 1] - ofs[rc];
      if (!Exchange(wire.data() + wofs[sc], QBytes(sm),
                    wire.data() + wofs[rc], QBytes(rm)))
        return -1;
      DequantInto<false>(wire.data() + wofs[rc], rm, data + ofs[rc]);
    }
    return 0;
  }

  // Ring broadcast from root: each non-root receives then forwards.
  int Broadcast(uint8_t* data, uint64_t nbytes, int root) {
    if (world_ == 1) return 0;
    if (rank_ == root) {
      return SendAll(send_fd_, data, nbytes) ? 0 : -1;
    }
    if (!RecvAll(recv_fd_, data, nbytes)) return -1;
    // Forward unless the next rank is the root (ring complete).
    if ((rank_ + 1) % world_ != root)
      return SendAll(send_fd_, data, nbytes) ? 0 : -1;
    return 0;
  }

  int rank() const { return rank_; }
  int world() const { return world_; }

 private:
  Ring(int rank, int world) : rank_(rank), world_(world) {}

  // Overlap send-to-next with recv-from-prev: one poll loop over both
  // nonblocking sockets (no per-step thread churn — this runs 2(W-1)
  // times per allreduce on per-step metric paths).
  bool Exchange(const void* sbuf, size_t sn, void* rbuf, size_t rn) {
    const char* sp = static_cast<const char*>(sbuf);
    char* rp = static_cast<char*>(rbuf);
    while (sn > 0 || rn > 0) {
      pollfd fds[2];
      int nf = 0, si = -1, ri = -1;
      if (sn > 0) { fds[nf] = {send_fd_, POLLOUT, 0}; si = nf++; }
      if (rn > 0) { fds[nf] = {recv_fd_, POLLIN, 0}; ri = nf++; }
      if (::poll(fds, nf, -1) < 0) {
        if (errno == EINTR) continue;
        return false;
      }
      if (si >= 0 && (fds[si].revents & (POLLOUT | POLLERR | POLLHUP))) {
        ssize_t k = ::send(send_fd_, sp, sn, MSG_NOSIGNAL);
        if (k < 0 && errno != EINTR && errno != EAGAIN &&
            errno != EWOULDBLOCK)
          return false;
        if (k > 0) { sp += k; sn -= static_cast<size_t>(k); }
      }
      if (ri >= 0 && (fds[ri].revents & (POLLIN | POLLERR | POLLHUP))) {
        ssize_t k = ::recv(recv_fd_, rp, rn, 0);
        if (k == 0) return false;  // peer closed
        if (k < 0 && errno != EINTR && errno != EAGAIN &&
            errno != EWOULDBLOCK)
          return false;
        if (k > 0) { rp += k; rn -= static_cast<size_t>(k); }
      }
    }
    return true;
  }

  int rank_, world_;
  int listen_fd_ = -1, send_fd_ = -1, recv_fd_ = -1;

  friend Ring* MakeRing(int, int, const std::string&, int);
};

// Full-duplex exchange over ONE socket (butterfly/mesh links are a single
// bidirectional connection per partner, unlike the ring's two).
bool ExchangeFd(int fd, const void* sbuf, size_t sn, void* rbuf, size_t rn) {
  const char* sp = static_cast<const char*>(sbuf);
  char* rp = static_cast<char*>(rbuf);
  while (sn > 0 || rn > 0) {
    short ev = 0;
    if (sn > 0) ev |= POLLOUT;
    if (rn > 0) ev |= POLLIN;
    pollfd pf{fd, ev, 0};
    if (::poll(&pf, 1, -1) < 0) {
      if (errno == EINTR) continue;
      return false;
    }
    if (sn > 0 && (pf.revents & (POLLOUT | POLLERR | POLLHUP))) {
      ssize_t k = ::send(fd, sp, sn, MSG_NOSIGNAL);
      if (k < 0 && errno != EINTR && errno != EAGAIN && errno != EWOULDBLOCK)
        return false;
      if (k > 0) { sp += k; sn -= static_cast<size_t>(k); }
    }
    if (rn > 0 && (pf.revents & (POLLIN | POLLERR | POLLHUP))) {
      ssize_t k = ::recv(fd, rp, rn, 0);
      if (k == 0) return false;
      if (k < 0 && errno != EINTR && errno != EAGAIN && errno != EWOULDBLOCK)
        return false;
      if (k > 0) { rp += k; rn -= static_cast<size_t>(k); }
    }
  }
  return true;
}

// Fully-connected host group for the butterfly/shuffle algorithms the
// reference ships as graph builders (`distribute/v1/all_reduce.py`:
// `build_recursive_hd_all_reduce:422`, `build_shuffle_all_reduce:554`).
// One bidirectional TCP connection per peer pair; rank i initiates to all
// j > i (kernel backlog makes connect-before-accept safe), identifying
// itself with a 4-byte rank handshake.
class MeshGroup {
 public:
  static MeshGroup* Create(int rank, int world, const std::string& peers,
                           int timeout_ms);

  ~MeshGroup() {
    for (int fd : fds_)
      if (fd >= 0) ::close(fd);
    if (listen_fd_ >= 0) ::close(listen_fd_);
  }

  // Recursive halving-doubling allreduce (Rabenseifner): latency-optimal
  // 2·log2(W) exchanges. Requires power-of-2 world (callers fall back to
  // the ring otherwise, like the reference's upfront_shuffle pad).
  int AllreduceHdF32(float* data, uint64_t n) {
    if (world_ == 1) return 0;
    if (world_ & (world_ - 1)) return -2;  // not a power of 2
    uint64_t lo = 0, hi = n;
    std::vector<uint64_t> los, his;  // segment stack for the gather phase
    std::vector<float> inbox(n / 2 + 1);
    // Reduce-scatter by recursive halving. rank and rank^mask share the
    // same active segment (it is determined by already-processed bits),
    // so both compute the same midpoint.
    for (int mask = 1; mask < world_; mask <<= 1) {
      los.push_back(lo);
      his.push_back(hi);
      const uint64_t mid = lo + (hi - lo) / 2;
      const int partner_fd = fds_[rank_ ^ mask];
      uint64_t keep_lo, keep_hi, send_lo, send_hi;
      if (rank_ & mask) {  // keep upper half
        keep_lo = mid; keep_hi = hi; send_lo = lo; send_hi = mid;
      } else {             // keep lower half
        keep_lo = lo; keep_hi = mid; send_lo = mid; send_hi = hi;
      }
      if (!ExchangeFd(partner_fd, data + send_lo, (send_hi - send_lo) * 4,
                      inbox.data(), (keep_hi - keep_lo) * 4))
        return -1;
      float* dst = data + keep_lo;
      const uint64_t m = keep_hi - keep_lo;
      for (uint64_t i = 0; i < m; ++i) dst[i] += inbox[i];
      lo = keep_lo;
      hi = keep_hi;
    }
    // All-gather by recursive doubling (reverse the split stack).
    for (int mask = world_ >> 1; mask >= 1; mask >>= 1) {
      const uint64_t plo = los.back(), phi = his.back();
      los.pop_back();
      his.pop_back();
      const uint64_t mid = plo + (phi - plo) / 2;
      const int partner_fd = fds_[rank_ ^ mask];
      // Which half we kept is decided by the rank bit (same rule as the
      // halving phase) — comparing lo against plo is ambiguous when a
      // split produced an empty segment (mid == plo).
      uint64_t other_lo, other_hi;
      if (rank_ & mask) {  // we kept upper; partner holds lower
        other_lo = plo; other_hi = mid;
      } else {
        other_lo = mid; other_hi = phi;
      }
      if (!ExchangeFd(partner_fd, data + lo, (hi - lo) * 4,
                      data + other_lo, (other_hi - other_lo) * 4))
        return -1;
      lo = plo;
      hi = phi;
    }
    return 0;
  }

  // Shuffle allreduce: direct reduce-scatter (every rank sends chunk c to
  // its owner) then direct all-gather — 2(W-1) single-hop messages, the
  // reference's `build_shuffle_all_reduce` with gather shards == ranks.
  // Rounds use XOR perfect matchings (partner = rank ^ s) so both ends of
  // every exchange are in the same round — any other schedule can deadlock
  // once messages exceed kernel socket buffers.  Power-of-2 world only.
  int AllreduceShuffleF32(float* data, uint64_t n) {
    if (world_ == 1) return 0;
    if (world_ & (world_ - 1)) return -2;  // not a power of 2
    const uint64_t W = static_cast<uint64_t>(world_);
    std::vector<uint64_t> ofs(W + 1);
    for (uint64_t c = 0; c <= W; ++c) ofs[c] = n * c / W;
    const uint64_t own_lo = ofs[rank_], own_hi = ofs[rank_ + 1];
    std::vector<float> inbox(own_hi - own_lo);
    // Phase 1: pairwise-exchange chunks toward their owners, accumulate.
    for (int s = 1; s < world_; ++s) {
      const int p = rank_ ^ s;
      if (!ExchangeFd(fds_[p], data + ofs[p], (ofs[p + 1] - ofs[p]) * 4,
                      inbox.data(), (own_hi - own_lo) * 4))
        return -1;
      for (uint64_t i = 0; i < own_hi - own_lo; ++i)
        data[own_lo + i] += inbox[i];
    }
    // Phase 2: exchange reduced chunks until everyone has all of them.
    for (int s = 1; s < world_; ++s) {
      const int p = rank_ ^ s;
      if (!ExchangeFd(fds_[p], data + own_lo, (own_hi - own_lo) * 4,
                      data + ofs[p], (ofs[p + 1] - ofs[p]) * 4))
        return -1;
    }
    return 0;
  }

  int rank() const { return rank_; }
  int world() const { return world_; }

 private:
  MeshGroup(int rank, int world) : rank_(rank), world_(world) {
    fds_.assign(world, -1);
  }

  int rank_, world_;
  int listen_fd_ = -1;
  std::vector<int> fds_;  // per-peer connection; own slot stays -1

  friend MeshGroup* MakeMesh(int, int, const std::string&, int);
};

std::vector<std::pair<std::string, int>> ParsePeers(const std::string& s) {
  std::vector<std::pair<std::string, int>> out;
  size_t pos = 0;
  while (pos < s.size()) {
    size_t comma = s.find(',', pos);
    if (comma == std::string::npos) comma = s.size();
    std::string item = s.substr(pos, comma - pos);
    size_t colon = item.rfind(':');
    if (colon == std::string::npos) return {};
    out.emplace_back(item.substr(0, colon),
                     std::atoi(item.c_str() + colon + 1));
    pos = comma + 1;
  }
  return out;
}

Ring* MakeRing(int rank, int world, const std::string& peers,
               int timeout_ms) {
  auto addrs = ParsePeers(peers);
  if (static_cast<int>(addrs.size()) != world || rank < 0 || rank >= world)
    return nullptr;
  if (world == 1) {
    Ring* r = new Ring(rank, world);
    return r;
  }

  // Listen on our advertised port for the predecessor.
  int lfd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (lfd < 0) return nullptr;
  int one = 1;
  ::setsockopt(lfd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = INADDR_ANY;
  addr.sin_port = htons(static_cast<uint16_t>(addrs[rank].second));
  if (::bind(lfd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) < 0 ||
      ::listen(lfd, 4) < 0) {
    ::close(lfd);
    return nullptr;
  }

  // Connect to successor (retry until its listener is up or timeout).
  int next = (rank + 1) % world;
  int sfd = -1;
  int waited = 0;
  for (; waited < timeout_ms; waited += 50) {
    sfd = ::socket(AF_INET, SOCK_STREAM, 0);
    sockaddr_in peer{};
    peer.sin_family = AF_INET;
    peer.sin_port = htons(static_cast<uint16_t>(addrs[next].second));
    if (::inet_pton(AF_INET, addrs[next].first.c_str(), &peer.sin_addr) != 1) {
      // Resolve "localhost" only; full DNS is the Python layer's job.
      if (addrs[next].first == "localhost")
        ::inet_pton(AF_INET, "127.0.0.1", &peer.sin_addr);
      else {
        ::close(sfd);
        ::close(lfd);
        return nullptr;
      }
    }
    if (::connect(sfd, reinterpret_cast<sockaddr*>(&peer), sizeof(peer)) == 0)
      break;
    ::close(sfd);
    sfd = -1;
    ::usleep(50 * 1000);
  }
  if (sfd < 0) {
    ::close(lfd);
    return nullptr;
  }
  ::setsockopt(sfd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));

  // Accept the predecessor, spending whatever remains of the timeout
  // budget — a predecessor that dies after our connect succeeded must
  // surface as setup failure, not an indefinite accept() hang.
  pollfd lpf{lfd, POLLIN, 0};
  int remaining = timeout_ms - waited;
  if (::poll(&lpf, 1, remaining > 0 ? remaining : 1) <= 0) {
    ::close(sfd);
    ::close(lfd);
    return nullptr;
  }
  int rfd = ::accept(lfd, nullptr, nullptr);
  if (rfd < 0) {
    ::close(sfd);
    ::close(lfd);
    return nullptr;
  }
  ::setsockopt(rfd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  ::fcntl(sfd, F_SETFL, ::fcntl(sfd, F_GETFL) | O_NONBLOCK);
  ::fcntl(rfd, F_SETFL, ::fcntl(rfd, F_GETFL) | O_NONBLOCK);

  Ring* r = new Ring(rank, world);
  r->listen_fd_ = lfd;
  r->send_fd_ = sfd;
  r->recv_fd_ = rfd;
  return r;
}

MeshGroup* MakeMesh(int rank, int world, const std::string& peers,
                    int timeout_ms) {
  auto addrs = ParsePeers(peers);
  if (static_cast<int>(addrs.size()) != world || rank < 0 || rank >= world)
    return nullptr;
  MeshGroup* g = new MeshGroup(rank, world);
  if (world == 1) return g;

  int lfd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (lfd < 0) { delete g; return nullptr; }
  int one = 1;
  ::setsockopt(lfd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = INADDR_ANY;
  addr.sin_port = htons(static_cast<uint16_t>(addrs[rank].second));
  if (::bind(lfd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) < 0 ||
      ::listen(lfd, world) < 0) {
    ::close(lfd);
    delete g;
    return nullptr;
  }
  g->listen_fd_ = lfd;

  // Outbound to every higher rank (connect succeeds once the peer's
  // listener is bound, even before it calls accept — kernel backlog).
  // Wall-clock deadline shared across all setup; every peer is guaranteed
  // at least one connect attempt even if earlier peers ate the budget.
  auto fail = [&]() { delete g; return static_cast<MeshGroup*>(nullptr); };
  auto now_ms = []() {
    timespec ts;
    ::clock_gettime(CLOCK_MONOTONIC, &ts);
    return static_cast<int64_t>(ts.tv_sec) * 1000 + ts.tv_nsec / 1000000;
  };
  const int64_t deadline = now_ms() + timeout_ms;
  for (int p = rank + 1; p < world; ++p) {
    int sfd = -1;
    for (bool first = true; first || now_ms() < deadline; first = false) {
      sfd = ::socket(AF_INET, SOCK_STREAM, 0);
      sockaddr_in peer{};
      peer.sin_family = AF_INET;
      peer.sin_port = htons(static_cast<uint16_t>(addrs[p].second));
      const std::string& host =
          addrs[p].first == "localhost" ? "127.0.0.1" : addrs[p].first;
      if (::inet_pton(AF_INET, host.c_str(), &peer.sin_addr) != 1) {
        ::close(sfd);
        return fail();
      }
      if (::connect(sfd, reinterpret_cast<sockaddr*>(&peer),
                    sizeof(peer)) == 0)
        break;
      ::close(sfd);
      sfd = -1;
      ::usleep(50 * 1000);
    }
    if (sfd < 0) return fail();
    ::setsockopt(sfd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
    uint32_t me = static_cast<uint32_t>(rank);
    if (!SendAll(sfd, &me, 4)) { ::close(sfd); return fail(); }
    g->fds_[p] = sfd;
  }
  // Inbound from every lower rank, identified by handshake.
  for (int i = 0; i < rank; ++i) {
    pollfd lpf{lfd, POLLIN, 0};
    int64_t remaining = deadline - now_ms();
    if (::poll(&lpf, 1, remaining > 0
                            ? static_cast<int>(remaining)
                            : 1) <= 0)
      return fail();
    int rfd = ::accept(lfd, nullptr, nullptr);
    if (rfd < 0) return fail();
    ::setsockopt(rfd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
    // Deadline-bounded handshake read: a stray connection (port scanner,
    // stale peer from a crashed run) that never sends its rank must not
    // hang setup past timeout_ms.
    uint32_t who = 0;
    char* hp = reinterpret_cast<char*>(&who);
    size_t hn = 4;
    bool hs_ok = true;
    while (hn > 0) {
      pollfd hpf{rfd, POLLIN, 0};
      int64_t hrem = deadline - now_ms();
      if (::poll(&hpf, 1, hrem > 0 ? static_cast<int>(hrem) : 1) <= 0) {
        hs_ok = false;
        break;
      }
      ssize_t k = ::recv(rfd, hp, hn, 0);
      if (k <= 0) {
        if (k < 0 && errno == EINTR) continue;
        hs_ok = false;
        break;
      }
      hp += k;
      hn -= static_cast<size_t>(k);
    }
    if (!hs_ok || who >= static_cast<uint32_t>(rank) ||
        g->fds_[who] != -1) {
      ::close(rfd);
      return fail();
    }
    g->fds_[who] = rfd;
  }
  for (int p = 0; p < world; ++p) {
    if (p == rank) continue;
    ::fcntl(g->fds_[p], F_SETFL, ::fcntl(g->fds_[p], F_GETFL) | O_NONBLOCK);
  }
  return g;
}

}  // namespace

extern "C" {

void* ttd_mesh_create(int rank, int world, const char* peers,
                      int timeout_ms) {
  return MakeMesh(rank, world, peers ? peers : "", timeout_ms);
}

int ttd_mesh_allreduce_hd_f32(void* g, float* data, uint64_t n) {
  return static_cast<MeshGroup*>(g)->AllreduceHdF32(data, n);
}

int ttd_mesh_allreduce_shuffle_f32(void* g, float* data, uint64_t n) {
  return static_cast<MeshGroup*>(g)->AllreduceShuffleF32(data, n);
}

int ttd_mesh_rank(void* g) { return static_cast<MeshGroup*>(g)->rank(); }
int ttd_mesh_world(void* g) { return static_cast<MeshGroup*>(g)->world(); }

void ttd_mesh_destroy(void* g) { delete static_cast<MeshGroup*>(g); }

void* ttd_ring_create(int rank, int world, const char* peers,
                      int timeout_ms) {
  return MakeRing(rank, world, peers ? peers : "", timeout_ms);
}

int ttd_ring_allreduce_q8_f32(void* r, float* data, uint64_t n) {
  return static_cast<Ring*>(r)->AllreduceQ8F32(data, n);
}

int ttd_ring_allreduce_f32(void* r, float* data, uint64_t n) {
  return static_cast<Ring*>(r)->AllreduceF32(data, n);
}

int ttd_ring_broadcast(void* r, uint8_t* data, uint64_t nbytes, int root) {
  return static_cast<Ring*>(r)->Broadcast(data, nbytes, root);
}

int ttd_ring_rank(void* r) { return static_cast<Ring*>(r)->rank(); }
int ttd_ring_world(void* r) { return static_cast<Ring*>(r)->world(); }

void ttd_ring_destroy(void* r) { delete static_cast<Ring*>(r); }

}  // extern "C"
