// tvts_torch native video decoder: FFmpeg (libavformat/libavcodec/libswscale).
//
// The port's own copy of tvts_tpu/cpp/decoder.cc (the same C ABI), built by
// tvts_torch/data/native_decoder.py into tvts_torch/_build/. It replaces the
// reference's decord/OpenCV decode dependencies: the requested frame indices
// of a video are decoded in ONE sequential pass (indices sorted internally),
// seeking to the nearest keyframe before each gap; colour conversion and an
// optional resize happen in the decoder via swscale, so Python receives ready
// RGB24 frames.
//
// C ABI (ctypes-friendly):
//   tvts_probe(path, &n_frames, &duration, &width, &height) -> 0/err
//   tvts_decode(path, idxs, n_idxs, out_w, out_h, out_buf)  -> 0/err
//     out_buf: n_idxs * out_h * out_w * 3 bytes (caller-allocated)
//     out_w/out_h == 0 means native size.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <vector>

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/imgutils.h>
#include <libswscale/swscale.h>
}

namespace {

struct VideoCtx {
  AVFormatContext* fmt = nullptr;
  AVCodecContext* dec = nullptr;
  int stream_idx = -1;

  ~VideoCtx() {
    if (dec) avcodec_free_context(&dec);
    if (fmt) avformat_close_input(&fmt);
  }

  int open(const char* path) {
    if (avformat_open_input(&fmt, path, nullptr, nullptr) < 0) return -1;
    if (avformat_find_stream_info(fmt, nullptr) < 0) return -2;
    stream_idx =
        av_find_best_stream(fmt, AVMEDIA_TYPE_VIDEO, -1, -1, nullptr, 0);
    if (stream_idx < 0) return -3;
    const AVStream* st = fmt->streams[stream_idx];
    const AVCodec* codec = avcodec_find_decoder(st->codecpar->codec_id);
    if (!codec) return -4;
    dec = avcodec_alloc_context3(codec);
    if (!dec) return -5;
    if (avcodec_parameters_to_context(dec, st->codecpar) < 0) return -6;
    dec->thread_count = 1;  // per-worker single-thread (pipeline parallelism
                            // comes from the loader's worker pool)
    if (avcodec_open2(dec, codec, nullptr) < 0) return -7;
    return 0;
  }

  AVStream* stream() const { return fmt->streams[stream_idx]; }

  double fps() const {
    AVRational r = stream()->avg_frame_rate;
    if (r.num == 0 || r.den == 0) r = stream()->r_frame_rate;
    if (r.num == 0 || r.den == 0) return 0.0;
    return av_q2d(r);
  }

  double duration_sec() const {
    if (stream()->duration > 0)
      return stream()->duration * av_q2d(stream()->time_base);
    if (fmt->duration > 0) return fmt->duration / (double)AV_TIME_BASE;
    return 0.0;
  }

  int64_t n_frames() const {
    if (stream()->nb_frames > 0) return stream()->nb_frames;
    // estimate like cv2's CAP_PROP_FRAME_COUNT: duration * fps
    double d = duration_sec(), f = fps();
    if (d > 0 && f > 0) return (int64_t)(d * f + 0.5);
    return 0;
  }
};

}  // namespace

extern "C" {

int tvts_probe(const char* path, int64_t* n_frames, double* duration,
               int* width, int* height, double* fps) {
  VideoCtx v;
  int rc = v.open(path);
  if (rc != 0) return rc;
  if (n_frames) *n_frames = v.n_frames();
  if (duration) *duration = v.duration_sec();
  if (width) *width = v.dec->width;
  if (height) *height = v.dec->height;
  if (fps) *fps = v.fps();
  return 0;
}

// Shared decode loop. crop_w <= 0 disables cropping; hflip mirrors
// horizontally. Implements the reference ffmpeg-filtergraph fast path
// (crop + hflip fused into decode, base_dataset_yt.py:394-436) without
// spawning an ffmpeg process.
static int decode_impl(const char* path, const int64_t* idxs, int n_idxs,
                       int crop_x, int crop_y, int crop_w, int crop_h,
                       int out_w, int out_h, int hflip, uint8_t* out) {
  if (n_idxs <= 0) return 0;
  VideoCtx v;
  int rc = v.open(path);
  if (rc != 0) return rc;

  if (crop_w > 0) {
    // clamp the window into the frame; even-align the origin for chroma
    crop_w = std::min(crop_w, v.dec->width);
    crop_h = std::min(crop_h, v.dec->height);
    crop_x = std::min(std::max(crop_x, 0), v.dec->width - crop_w) & ~1;
    crop_y = std::min(std::max(crop_y, 0), v.dec->height - crop_h) & ~1;
  }
  const int src_w = crop_w > 0 ? crop_w : v.dec->width;
  const int src_h = crop_h > 0 ? crop_h : v.dec->height;
  const int W = out_w > 0 ? out_w : src_w;
  const int H = out_h > 0 ? out_h : src_h;
  const size_t frame_bytes = (size_t)W * H * 3;

  // sort requests, remember original slots (duplicates allowed)
  std::vector<int> order(n_idxs);
  std::iota(order.begin(), order.end(), 0);
  std::sort(order.begin(), order.end(),
            [&](int a, int b) { return idxs[a] < idxs[b]; });

  AVStream* st = v.stream();
  const double fp = v.fps();
  const double tb = av_q2d(st->time_base);

  SwsContext* sws = nullptr;
  AVFrame* frame = av_frame_alloc();
  AVPacket* pkt = av_packet_alloc();
  uint8_t* rgb_data[4] = {nullptr};
  int rgb_lines[4] = {0};
  av_image_alloc(rgb_data, rgb_lines, W, H, AV_PIX_FMT_RGB24, 32);

  int64_t cur_frame = -1;   // index of the last decoded frame
  int req = 0;              // next request slot in sorted order
  int err = 0;
  bool need_seek = true;    // initial position unknown
  int64_t seek_target = idxs[order[0]];

  auto emit = [&](int64_t fidx) {
    // hand the current decoded `frame` to every pending request for fidx
    while (req < n_idxs && idxs[order[req]] <= fidx) {
      AVFrame* src_frame = frame;
      AVFrame cropped;
      if (crop_w > 0) {
        // crop via pointer adjustment before the swscale conversion
        memcpy(&cropped, frame, sizeof(AVFrame));
        cropped.crop_left = crop_x;
        cropped.crop_top = crop_y;
        cropped.crop_right = frame->width - crop_x - crop_w;
        cropped.crop_bottom = frame->height - crop_y - crop_h;
        if (av_frame_apply_cropping(&cropped, AV_FRAME_CROP_UNALIGNED) >= 0)
          src_frame = &cropped;
      }
      if (!sws) {
        sws = sws_getContext(src_w, src_h, (AVPixelFormat)frame->format, W, H,
                             AV_PIX_FMT_RGB24, SWS_BILINEAR, nullptr, nullptr,
                             nullptr);
      }
      sws_scale(sws, src_frame->data, src_frame->linesize, 0, src_h, rgb_data,
                rgb_lines);
      uint8_t* dst = out + (size_t)order[req] * frame_bytes;
      if (hflip) {
        for (int y = 0; y < H; ++y) {
          const uint8_t* srow = rgb_data[0] + (size_t)y * rgb_lines[0];
          uint8_t* drow = dst + (size_t)y * W * 3;
          for (int x = 0; x < W; ++x)
            memcpy(drow + (size_t)x * 3, srow + (size_t)(W - 1 - x) * 3, 3);
        }
      } else {
        for (int y = 0; y < H; ++y)
          memcpy(dst + (size_t)y * W * 3,
                 rgb_data[0] + (size_t)y * rgb_lines[0], (size_t)W * 3);
      }
      ++req;
    }
  };

  // re-seek instead of decoding through large gaps between sparse requests
  const int64_t kSeekGapThreshold = 48;

  while (req < n_idxs && !err) {
    if (!need_seek && cur_frame >= 0 &&
        idxs[order[req]] > cur_frame + kSeekGapThreshold) {
      need_seek = true;
      seek_target = idxs[order[req]];
    }
    if (need_seek) {
      // seek to keyframe at/before the target frame's timestamp
      int64_t ts = (fp > 0)
                       ? (int64_t)(seek_target / fp / tb)
                       : seek_target;
      if (av_seek_frame(v.fmt, v.stream_idx, ts, AVSEEK_FLAG_BACKWARD) >= 0)
        avcodec_flush_buffers(v.dec);
      cur_frame = -1;  // unknown until we decode a stamped frame
      need_seek = false;
    }

    int pr = av_read_frame(v.fmt, pkt);
    if (pr < 0) {
      // EOF: flush decoder
      avcodec_send_packet(v.dec, nullptr);
      while (avcodec_receive_frame(v.dec, frame) >= 0) {
        ++cur_frame;
        emit(cur_frame);
      }
      if (req < n_idxs && cur_frame >= 0) {
        // requests beyond the last frame: clamp to the final decoded frame
        emit(INT64_MAX - 1);
      }
      break;
    }
    if (pkt->stream_index != v.stream_idx) {
      av_packet_unref(pkt);
      continue;
    }
    if (avcodec_send_packet(v.dec, pkt) < 0) {
      av_packet_unref(pkt);
      continue;
    }
    av_packet_unref(pkt);
    while (avcodec_receive_frame(v.dec, frame) >= 0) {
      if (cur_frame < 0) {
        // derive the frame index from the first stamped frame after a seek
        int64_t pts = frame->best_effort_timestamp;
        if (pts == AV_NOPTS_VALUE) pts = frame->pts;
        cur_frame = (pts != AV_NOPTS_VALUE && fp > 0)
                        ? (int64_t)(pts * tb * fp + 0.5)
                        : 0;
      } else {
        ++cur_frame;
      }
      if (cur_frame >= idxs[order[req]]) emit(cur_frame);
    }
  }

  av_packet_free(&pkt);
  av_frame_free(&frame);
  av_freep(&rgb_data[0]);
  if (sws) sws_freeContext(sws);
  return (req == n_idxs) ? 0 : -100 - req;
}

// Decode frames at the given indices into out (RGB24, [n, out_h, out_w, 3]).
int tvts_decode(const char* path, const int64_t* idxs, int n_idxs, int out_w,
                int out_h, uint8_t* out) {
  return decode_impl(path, idxs, n_idxs, 0, 0, 0, 0, out_w, out_h, 0, out);
}

// Fast-path decode with fused crop window + optional horizontal flip.
int tvts_decode_aug(const char* path, const int64_t* idxs, int n_idxs,
                    int crop_x, int crop_y, int crop_w, int crop_h, int out_w,
                    int out_h, int hflip, uint8_t* out) {
  return decode_impl(path, idxs, n_idxs, crop_x, crop_y, crop_w, crop_h,
                     out_w, out_h, hflip, out);
}

}  // extern "C"
