// C++ shim over the system ffmpeg libraries (libavcodec/libavformat/
// libswscale/libswresample): the port's copy of mixlab_tpu/native/avshim.cpp.
//
// The equivalent of the reference's codec crate FFI boundary
// (codec/src/ffmpeg.rs, codec.rs, format.rs, ioctx.rs and avc/encode.rs):
// safe-ish C entry points over the raw C API, consumed from Python via
// ctypes (mixlab_tpu_torch/native/avshim.py).  Only the host codec path
// lives here — scaling/compositing stays on the device (video/scale.py,
// video/blend.py), so swscale is used solely for pixel-format normalization
// to yuv420p.  Host code, not a device kernel.
//
// Build: g++ -O2 -shared -fPIC avshim.cpp -lavcodec -lavformat -lavutil
//        -lswscale -lswresample

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/imgutils.h>
#include <libavutil/opt.h>
#include <libswresample/swresample.h>
#include <libswscale/swscale.h>
}

#include <cstring>
#include <cstdint>

namespace {

struct VEnc {
    AVCodecContext* ctx = nullptr;
    AVFrame* frame = nullptr;
    AVPacket* pkt = nullptr;
};

struct AEnc {
    AVCodecContext* ctx = nullptr;
    AVFrame* frame = nullptr;
    AVPacket* pkt = nullptr;
    // rebuffering: collect arbitrary-size pushes into frame_size granules
    float* fifo = nullptr;  // interleaved float
    int fifo_len = 0;       // frames buffered
    int fifo_cap = 0;
    int64_t next_pts = 0;
};

struct ADec {
    AVCodecContext* ctx = nullptr;
    AVFrame* frame = nullptr;
    AVPacket* pkt = nullptr;
    SwrContext* swr = nullptr;
    SwrContext* swr_f = nullptr;  // float-output path (oracle/extraction)
    int out_rate = 0;
};

struct VDec {
    AVCodecContext* ctx = nullptr;
    AVFrame* frame = nullptr;
    AVPacket* pkt = nullptr;
    SwsContext* sws = nullptr;
};

struct Media {
    AVFormatContext* fmt = nullptr;
    AVIOContext* avio = nullptr;  // set for callback-IO opens (owned)
    int a_idx = -1, v_idx = -1;
    AVCodecContext* adec = nullptr;
    AVCodecContext* vdec = nullptr;
    AVFrame* frame = nullptr;
    AVPacket* pkt = nullptr;
    SwrContext* swr = nullptr;
    SwsContext* sws = nullptr;
    bool draining = false;
    bool a_eof = true, v_eof = true;
};

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// video encoder (codec/src/avc/encode.rs analogue; profiles set by opts)
// ---------------------------------------------------------------------------

void* avshim_venc_open(const char* codec_name, int w, int h, int fps_num,
                       int fps_den, const char* opts) {
    const AVCodec* codec = avcodec_find_encoder_by_name(codec_name);
    if (!codec) return nullptr;
    VEnc* e = new VEnc();
    e->ctx = avcodec_alloc_context3(codec);
    e->ctx->width = w;
    e->ctx->height = h;
    e->ctx->pix_fmt = AV_PIX_FMT_YUV420P;
    e->ctx->time_base = AVRational{fps_den, fps_num};
    e->ctx->framerate = AVRational{fps_num, fps_den};
    // GLOBAL_HEADER: SPS/PPS in extradata (encode.rs:121-127 equivalent)
    e->ctx->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;
    AVDictionary* d = nullptr;
    if (opts && *opts) av_dict_parse_string(&d, opts, "=", ",", 0);
    int rc = avcodec_open2(e->ctx, codec, &d);
    av_dict_free(&d);
    if (rc < 0) {
        avcodec_free_context(&e->ctx);
        delete e;
        return nullptr;
    }
    e->frame = av_frame_alloc();
    e->frame->format = AV_PIX_FMT_YUV420P;
    e->frame->width = w;
    e->frame->height = h;
    av_frame_get_buffer(e->frame, 0);
    e->pkt = av_packet_alloc();
    return e;
}

int avshim_venc_extradata(void* h, uint8_t* buf, int cap) {
    VEnc* e = (VEnc*)h;
    int n = e->ctx->extradata_size;
    if (buf && n <= cap) memcpy(buf, e->ctx->extradata, n);
    return n;
}

int avshim_venc_send(void* h, const uint8_t* y, int ystride, const uint8_t* u,
                     int ustride, const uint8_t* v, int vstride, int64_t pts) {
    VEnc* e = (VEnc*)h;
    av_frame_make_writable(e->frame);
    int hh = e->ctx->height;
    for (int r = 0; r < hh; r++)
        memcpy(e->frame->data[0] + r * e->frame->linesize[0], y + r * ystride,
               e->ctx->width);
    for (int r = 0; r < hh / 2; r++) {
        memcpy(e->frame->data[1] + r * e->frame->linesize[1], u + r * ustride,
               e->ctx->width / 2);
        memcpy(e->frame->data[2] + r * e->frame->linesize[2], v + r * vstride,
               e->ctx->width / 2);
    }
    e->frame->pts = pts;
    // x264 re-decides pict_type itself (encode.rs:287-294 clears it)
    e->frame->pict_type = AV_PICTURE_TYPE_NONE;
    return avcodec_send_frame(e->ctx, e->frame);
}

int avshim_venc_flush(void* h) {
    VEnc* e = (VEnc*)h;
    return avcodec_send_frame(e->ctx, nullptr);
}

int avshim_venc_receive(void* h, uint8_t* buf, int cap, int64_t* pts,
                        int64_t* dts, int* key) {
    VEnc* e = (VEnc*)h;
    int rc = avcodec_receive_packet(e->ctx, e->pkt);
    if (rc == AVERROR(EAGAIN) || rc == AVERROR_EOF) return 0;
    if (rc < 0) return rc;
    int n = e->pkt->size;
    if (n > cap) {
        av_packet_unref(e->pkt);
        return -1000 - n;  // caller must grow buffer
    }
    memcpy(buf, e->pkt->data, n);
    *pts = e->pkt->pts;
    *dts = e->pkt->dts;
    *key = (e->pkt->flags & AV_PKT_FLAG_KEY) ? 1 : 0;
    av_packet_unref(e->pkt);
    return n;
}

void avshim_venc_close(void* h) {
    VEnc* e = (VEnc*)h;
    avcodec_free_context(&e->ctx);
    av_frame_free(&e->frame);
    av_packet_free(&e->pkt);
    delete e;
}

// ---------------------------------------------------------------------------
// audio encoder (AAC; video/encode.rs:146-222 AudioCtx analogue)
// ---------------------------------------------------------------------------

// opts: av_dict_parse_string "k=v,k=v" codec options (e.g. the ffmpeg aac
// encoder's aac_pns/aac_tns/aac_ms/aac_is tool switches — used by the
// pure-tier AAC decoder's differential tests to target one tool at a time)
void* avshim_aenc_open2(const char* codec_name, int sample_rate, int channels,
                        int bitrate, const char* opts) {
    const AVCodec* codec = avcodec_find_encoder_by_name(codec_name);
    if (!codec) return nullptr;
    AEnc* e = new AEnc();
    e->ctx = avcodec_alloc_context3(codec);
    e->ctx->sample_rate = sample_rate;
    av_channel_layout_default(&e->ctx->ch_layout, channels);
    // pick a sample format the codec supports (AAC/vorbis/mp3lame want
    // FLTP; flac wants S16/S32)
    e->ctx->sample_fmt = AV_SAMPLE_FMT_FLTP;
    if (codec->sample_fmts) {
        bool has_fltp = false, has_s16 = false, has_s32 = false;
        for (const enum AVSampleFormat* f = codec->sample_fmts;
             *f != AV_SAMPLE_FMT_NONE; f++) {
            if (*f == AV_SAMPLE_FMT_FLTP) has_fltp = true;
            if (*f == AV_SAMPLE_FMT_S16) has_s16 = true;
            if (*f == AV_SAMPLE_FMT_S32) has_s32 = true;
        }
        if (has_fltp) e->ctx->sample_fmt = AV_SAMPLE_FMT_FLTP;
        else if (has_s16) e->ctx->sample_fmt = AV_SAMPLE_FMT_S16;
        else if (has_s32) e->ctx->sample_fmt = AV_SAMPLE_FMT_S32;
        else e->ctx->sample_fmt = codec->sample_fmts[0];
    }
    if (bitrate > 0) e->ctx->bit_rate = bitrate;
    e->ctx->time_base = AVRational{1, sample_rate};
    e->ctx->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;  // ASC in extradata
    AVDictionary* d = nullptr;
    if (opts && *opts) av_dict_parse_string(&d, opts, "=", ",", 0);
    int rc = avcodec_open2(e->ctx, codec, &d);
    av_dict_free(&d);
    if (rc < 0) {
        avcodec_free_context(&e->ctx);
        delete e;
        return nullptr;
    }
    e->frame = av_frame_alloc();
    e->pkt = av_packet_alloc();
    e->fifo_cap = e->ctx->frame_size * 8 + 65536;
    e->fifo = new float[(size_t)e->fifo_cap * channels];
    return e;
}

void* avshim_aenc_open(const char* codec_name, int sample_rate, int channels,
                       int bitrate) {
    return avshim_aenc_open2(codec_name, sample_rate, channels, bitrate,
                             nullptr);
}

int avshim_aenc_frame_size(void* h) { return ((AEnc*)h)->ctx->frame_size; }

int avshim_aenc_extradata(void* h, uint8_t* buf, int cap) {
    AEnc* e = (AEnc*)h;
    int n = e->ctx->extradata_size;
    if (buf && n <= cap) memcpy(buf, e->ctx->extradata, n);
    return n;
}

static int aenc_push_granules(AEnc* e) {
    int ch = e->ctx->ch_layout.nb_channels;
    int fs = e->ctx->frame_size;
    int sent = 0;
    while (e->fifo_len >= fs) {
        e->frame->format = e->ctx->sample_fmt;
        e->frame->nb_samples = fs;
        av_channel_layout_copy(&e->frame->ch_layout, &e->ctx->ch_layout);
        av_frame_get_buffer(e->frame, 0);
        if (e->ctx->sample_fmt == AV_SAMPLE_FMT_S16) {
            int16_t* dst = (int16_t*)e->frame->data[0];
            for (int i = 0; i < fs * ch; i++) {
                float v = e->fifo[i] * 32768.0f;
                if (v > 32767.0f) v = 32767.0f;
                if (v < -32768.0f) v = -32768.0f;
                dst[i] = (int16_t)lrintf(v);
            }
        } else if (e->ctx->sample_fmt == AV_SAMPLE_FMT_S32) {
            int32_t* dst = (int32_t*)e->frame->data[0];
            for (int i = 0; i < fs * ch; i++) {
                double v = (double)e->fifo[i] * 2147483648.0;
                if (v > 2147483647.0) v = 2147483647.0;
                if (v < -2147483648.0) v = -2147483648.0;
                dst[i] = (int32_t)llrint(v);
            }
        } else {
            for (int c = 0; c < ch; c++) {
                float* dst = (float*)e->frame->data[c];
                for (int i = 0; i < fs; i++)
                    dst[i] = e->fifo[(size_t)i * ch + c];
            }
        }
        e->frame->pts = e->next_pts;
        e->next_pts += fs;
        int rc = avcodec_send_frame(e->ctx, e->frame);
        av_frame_unref(e->frame);
        if (rc == AVERROR(EAGAIN)) break;  // drain receive side first
        if (rc < 0) return rc;
        e->fifo_len -= fs;
        memmove(e->fifo, e->fifo + (size_t)fs * ch,
                (size_t)e->fifo_len * ch * sizeof(float));
        sent++;
    }
    return sent;
}

int avshim_aenc_send(void* h, const int16_t* pcm, int nframes) {
    AEnc* e = (AEnc*)h;
    int ch = e->ctx->ch_layout.nb_channels;
    if (e->fifo_len + nframes > e->fifo_cap) return -1;
    float* dst = e->fifo + (size_t)e->fifo_len * ch;
    for (int i = 0; i < nframes * ch; i++) dst[i] = pcm[i] / 32768.0f;
    e->fifo_len += nframes;
    return aenc_push_granules(e);
}

int avshim_aenc_flush(void* h) {
    AEnc* e = (AEnc*)h;
    aenc_push_granules(e);
    return avcodec_send_frame(e->ctx, nullptr);
}

int avshim_aenc_receive(void* h, uint8_t* buf, int cap, int64_t* pts) {
    AEnc* e = (AEnc*)h;
    int rc = avcodec_receive_packet(e->ctx, e->pkt);
    if (rc == AVERROR(EAGAIN)) {
        // sending may have stalled on a full encoder: push pending granules
        aenc_push_granules(e);
        rc = avcodec_receive_packet(e->ctx, e->pkt);
    }
    if (rc == AVERROR(EAGAIN) || rc == AVERROR_EOF) return 0;
    if (rc < 0) return rc;
    int n = e->pkt->size;
    if (n > cap) {
        av_packet_unref(e->pkt);
        return -1000 - n;
    }
    memcpy(buf, e->pkt->data, n);
    *pts = e->pkt->pts;
    av_packet_unref(e->pkt);
    return n;
}

void avshim_aenc_close(void* h) {
    AEnc* e = (AEnc*)h;
    avcodec_free_context(&e->ctx);
    av_frame_free(&e->frame);
    av_packet_free(&e->pkt);
    delete[] e->fifo;
    delete e;
}

// ---------------------------------------------------------------------------
// audio decoder (rtmp/mod.rs:192-258 AAC ingest analogue)
// ---------------------------------------------------------------------------

// strict != 0 sets err_recognition EXPLODE|BITSTREAM|BUFFER: any bitstream
// parse error fails the decode instead of being concealed.  Used by the
// AAC table-extraction oracle (tools/extract_aac_tables.py), where
// "did this frame parse" is the measurement.
void* avshim_adec_open2(const char* codec_name, const uint8_t* extradata,
                        int extradata_len, int strict) {
    const AVCodec* codec = avcodec_find_decoder_by_name(codec_name);
    if (!codec) return nullptr;
    ADec* d = new ADec();
    d->ctx = avcodec_alloc_context3(codec);
    if (extradata_len > 0) {
        d->ctx->extradata = (uint8_t*)av_mallocz(extradata_len +
                                                 AV_INPUT_BUFFER_PADDING_SIZE);
        memcpy(d->ctx->extradata, extradata, extradata_len);
        d->ctx->extradata_size = extradata_len;
    }
    if (strict)
        d->ctx->err_recognition =
            AV_EF_EXPLODE | AV_EF_BITSTREAM | AV_EF_BUFFER;
    if (avcodec_open2(d->ctx, codec, nullptr) < 0) {
        avcodec_free_context(&d->ctx);
        delete d;
        return nullptr;
    }
    d->frame = av_frame_alloc();
    d->pkt = av_packet_alloc();
    return d;
}

void* avshim_adec_open(const char* codec_name, const uint8_t* extradata,
                       int extradata_len) {
    return avshim_adec_open2(codec_name, extradata, extradata_len, 0);
}

int avshim_adec_send(void* h, const uint8_t* data, int len, int64_t pts) {
    ADec* d = (ADec*)h;
    if (len == 0) return avcodec_send_packet(d->ctx, nullptr);
    uint8_t* buf = (uint8_t*)av_malloc(len + AV_INPUT_BUFFER_PADDING_SIZE);
    memcpy(buf, data, len);
    memset(buf + len, 0, AV_INPUT_BUFFER_PADDING_SIZE);
    av_packet_from_data(d->pkt, buf, len);
    d->pkt->pts = pts;
    int rc = avcodec_send_packet(d->ctx, d->pkt);
    av_packet_unref(d->pkt);
    return rc;
}

// returns frames written (interleaved s16); 0 = need more; <0 error
int avshim_adec_receive(void* h, int16_t* buf, int max_frames, int* channels,
                        int* sample_rate, int64_t* pts) {
    ADec* d = (ADec*)h;
    int rc = avcodec_receive_frame(d->ctx, d->frame);
    if (rc == AVERROR(EAGAIN) || rc == AVERROR_EOF) return 0;
    if (rc < 0) return rc;
    int ch = d->ctx->ch_layout.nb_channels;
    int n = d->frame->nb_samples;
    if (n > max_frames) n = max_frames;
    if (!d->swr) {
        swr_alloc_set_opts2(&d->swr, &d->ctx->ch_layout, AV_SAMPLE_FMT_S16,
                            d->ctx->sample_rate, &d->ctx->ch_layout,
                            (AVSampleFormat)d->frame->format,
                            d->ctx->sample_rate, 0, nullptr);
        swr_init(d->swr);
    }
    uint8_t* out[1] = {(uint8_t*)buf};
    int got = swr_convert(d->swr, out, n, (const uint8_t**)d->frame->data,
                          d->frame->nb_samples);
    *channels = ch;
    *sample_rate = d->ctx->sample_rate;
    *pts = d->frame->pts;
    av_frame_unref(d->frame);
    return got;
}

// float-interleaved receive: no s16 quantization on the way out.  The AAC
// extraction oracle inverts the filterbank on this output; 24 effective
// mantissa bits keep quantized-coefficient recovery exact.
int avshim_adec_receive_flt(void* h, float* buf, int max_frames,
                            int* channels, int* sample_rate, int64_t* pts) {
    ADec* d = (ADec*)h;
    int rc = avcodec_receive_frame(d->ctx, d->frame);
    if (rc == AVERROR(EAGAIN) || rc == AVERROR_EOF) return 0;
    if (rc < 0) return rc;
    int ch = d->ctx->ch_layout.nb_channels;
    int n = d->frame->nb_samples;
    if (n > max_frames) n = max_frames;
    if (!d->swr_f) {
        swr_alloc_set_opts2(&d->swr_f, &d->ctx->ch_layout, AV_SAMPLE_FMT_FLT,
                            d->ctx->sample_rate, &d->ctx->ch_layout,
                            (AVSampleFormat)d->frame->format,
                            d->ctx->sample_rate, 0, nullptr);
        swr_init(d->swr_f);
    }
    uint8_t* out[1] = {(uint8_t*)buf};
    int got = swr_convert(d->swr_f, out, n, (const uint8_t**)d->frame->data,
                          d->frame->nb_samples);
    *channels = ch;
    *sample_rate = d->ctx->sample_rate;
    *pts = d->frame->pts;
    av_frame_unref(d->frame);
    return got;
}

void avshim_adec_close(void* h) {
    ADec* d = (ADec*)h;
    avcodec_free_context(&d->ctx);
    av_frame_free(&d->frame);
    av_packet_free(&d->pkt);
    if (d->swr) swr_free(&d->swr);
    if (d->swr_f) swr_free(&d->swr_f);
    delete d;
}

// ---------------------------------------------------------------------------
// video decoder (rtmp/mod.rs:260-338 H.264 ingest analogue)
// ---------------------------------------------------------------------------

void* avshim_vdec_open(const char* codec_name, const uint8_t* extradata,
                       int extradata_len) {
    const AVCodec* codec = avcodec_find_decoder_by_name(codec_name);
    if (!codec) return nullptr;
    VDec* d = new VDec();
    d->ctx = avcodec_alloc_context3(codec);
    if (extradata_len > 0) {
        // avcC extradata switches the h264 parser to length-prefixed NALs
        // (rtmp/mod.rs:277-287 sets the DCR as extradata the same way)
        d->ctx->extradata = (uint8_t*)av_mallocz(extradata_len +
                                                 AV_INPUT_BUFFER_PADDING_SIZE);
        memcpy(d->ctx->extradata, extradata, extradata_len);
        d->ctx->extradata_size = extradata_len;
    }
    if (avcodec_open2(d->ctx, codec, nullptr) < 0) {
        avcodec_free_context(&d->ctx);
        delete d;
        return nullptr;
    }
    d->frame = av_frame_alloc();
    d->pkt = av_packet_alloc();
    return d;
}

int avshim_vdec_send(void* h, const uint8_t* data, int len, int64_t pts) {
    VDec* d = (VDec*)h;
    if (len == 0) return avcodec_send_packet(d->ctx, nullptr);
    uint8_t* buf = (uint8_t*)av_malloc(len + AV_INPUT_BUFFER_PADDING_SIZE);
    memcpy(buf, data, len);
    memset(buf + len, 0, AV_INPUT_BUFFER_PADDING_SIZE);
    av_packet_from_data(d->pkt, buf, len);
    d->pkt->pts = pts;
    int rc = avcodec_send_packet(d->ctx, d->pkt);
    av_packet_unref(d->pkt);
    return rc;
}

static int convert_to_yuv420(SwsContext** sws, AVFrame* frame, uint8_t* ybuf,
                             uint8_t* ubuf, uint8_t* vbuf, int* w, int* hh) {
    int W = frame->width, H = frame->height;
    *w = W;
    *hh = H;
    *sws = sws_getCachedContext(*sws, W, H, (AVPixelFormat)frame->format, W, H,
                                AV_PIX_FMT_YUV420P, SWS_BILINEAR, nullptr,
                                nullptr, nullptr);
    uint8_t* dst[4] = {ybuf, ubuf, vbuf, nullptr};
    int dstride[4] = {W, W / 2, W / 2, 0};
    sws_scale(*sws, frame->data, frame->linesize, 0, H, dst, dstride);
    return 1;
}

// returns 1 when a frame was written; 0 = need more; <0 error
int avshim_vdec_receive(void* h, uint8_t* ybuf, uint8_t* ubuf, uint8_t* vbuf,
                        int buf_cap, int* w, int* hh, int64_t* pts) {
    VDec* d = (VDec*)h;
    int rc = avcodec_receive_frame(d->ctx, d->frame);
    if (rc == AVERROR(EAGAIN) || rc == AVERROR_EOF) return 0;
    if (rc < 0) return rc;
    if (d->frame->width * d->frame->height > buf_cap) {
        av_frame_unref(d->frame);
        return -2000 - d->frame->width;  // caller must grow buffers
    }
    convert_to_yuv420(&d->sws, d->frame, ybuf, ubuf, vbuf, w, hh);
    *pts = d->frame->pts;
    av_frame_unref(d->frame);
    return 1;
}

void avshim_vdec_close(void* h) {
    VDec* d = (VDec*)h;
    avcodec_free_context(&d->ctx);
    av_frame_free(&d->frame);
    av_packet_free(&d->pkt);
    if (d->sws) sws_freeContext(d->sws);
    delete d;
}

// ---------------------------------------------------------------------------
// media file reader (media_source decode loop: media_source.rs:185-292 +
// ffmpeg::format InputContainer)
// ---------------------------------------------------------------------------

static void media_free_avio(Media* m) {
    if (m->avio) {
        av_freep(&m->avio->buffer);
        avio_context_free(&m->avio);
    }
}

// forward: shared setup after avformat_open_input succeeded
static void* media_finish_open(Media* m);

void* avshim_media_open(const char* path) {
    Media* m = new Media();
    if (avformat_open_input(&m->fmt, path, nullptr, nullptr) < 0) {
        delete m;
        return nullptr;
    }
    return media_finish_open(m);
}

// ---------------------------------------------------------------------------
// callback-IO open: demux straight from a host reader (the reference's
// Rust IoReader -> AVIO bridge, codec/src/ffmpeg/ioctx.rs:15-100), so
// project blob streams play without spooling to a temp file
// ---------------------------------------------------------------------------

typedef int (*avshim_read_cb)(void* opaque, uint8_t* buf, int n);
typedef int64_t (*avshim_seek_cb)(void* opaque, int64_t off, int whence);

void* avshim_media_open_io(void* opaque, avshim_read_cb read_cb,
                           avshim_seek_cb seek_cb) {
    const int IOBUF = 1 << 16;
    Media* m = new Media();
    unsigned char* buf = (unsigned char*)av_malloc(IOBUF);
    if (!buf) {
        delete m;
        return nullptr;
    }
    m->avio = avio_alloc_context(buf, IOBUF, 0, opaque, read_cb, nullptr,
                                 seek_cb);
    if (!m->avio) {
        av_free(buf);
        delete m;
        return nullptr;
    }
    m->fmt = avformat_alloc_context();
    if (!m->fmt) {
        media_free_avio(m);
        delete m;
        return nullptr;
    }
    m->fmt->pb = m->avio;
    if (avformat_open_input(&m->fmt, nullptr, nullptr, nullptr) < 0) {
        // on failure avformat_open_input frees the format context but not
        // the custom pb
        media_free_avio(m);
        delete m;
        return nullptr;
    }
    return media_finish_open(m);
}

static void* media_finish_open(Media* m) {
    if (avformat_find_stream_info(m->fmt, nullptr) < 0) {
        avformat_close_input(&m->fmt);
        media_free_avio(m);
        delete m;
        return nullptr;
    }
    m->a_idx = av_find_best_stream(m->fmt, AVMEDIA_TYPE_AUDIO, -1, -1, nullptr, 0);
    m->v_idx = av_find_best_stream(m->fmt, AVMEDIA_TYPE_VIDEO, -1, -1, nullptr, 0);
    if (m->a_idx >= 0) {
        const AVCodec* c = avcodec_find_decoder(
            m->fmt->streams[m->a_idx]->codecpar->codec_id);
        if (c) {
            m->adec = avcodec_alloc_context3(c);
            avcodec_parameters_to_context(m->adec,
                                          m->fmt->streams[m->a_idx]->codecpar);
            if (avcodec_open2(m->adec, c, nullptr) < 0)
                avcodec_free_context(&m->adec);
        }
        if (!m->adec) m->a_idx = -1;
    }
    if (m->v_idx >= 0) {
        const AVCodec* c = avcodec_find_decoder(
            m->fmt->streams[m->v_idx]->codecpar->codec_id);
        if (c) {
            m->vdec = avcodec_alloc_context3(c);
            avcodec_parameters_to_context(m->vdec,
                                          m->fmt->streams[m->v_idx]->codecpar);
            if (avcodec_open2(m->vdec, c, nullptr) < 0)
                avcodec_free_context(&m->vdec);
        }
        if (!m->vdec) m->v_idx = -1;
    }
    if (m->a_idx < 0 && m->v_idx < 0) {
        avformat_close_input(&m->fmt);
        media_free_avio(m);
        delete m;
        return nullptr;
    }
    m->a_eof = m->a_idx < 0;
    m->v_eof = m->v_idx < 0;
    m->frame = av_frame_alloc();
    m->pkt = av_packet_alloc();
    return m;
}

int avshim_media_audio_info(void* h, int* rate, int* channels, int* tb_num,
                            int* tb_den) {
    Media* m = (Media*)h;
    if (m->a_idx < 0) return 0;
    *rate = m->adec->sample_rate;
    *channels = m->adec->ch_layout.nb_channels;
    *tb_num = m->fmt->streams[m->a_idx]->time_base.num;
    *tb_den = m->fmt->streams[m->a_idx]->time_base.den;
    return 1;
}

int avshim_media_video_info(void* h, int* w, int* hh, int* tb_num, int* tb_den,
                            int* fps_num, int* fps_den) {
    Media* m = (Media*)h;
    if (m->v_idx < 0) return 0;
    *w = m->vdec->width;
    *hh = m->vdec->height;
    *tb_num = m->fmt->streams[m->v_idx]->time_base.num;
    *tb_den = m->fmt->streams[m->v_idx]->time_base.den;
    AVRational fr = m->fmt->streams[m->v_idx]->avg_frame_rate;
    if (fr.num <= 0 || fr.den <= 0) fr = m->fmt->streams[m->v_idx]->r_frame_rate;
    if (fr.num <= 0 || fr.den <= 0) { fr.num = 30; fr.den = 1; }
    *fps_num = fr.num;
    *fps_den = fr.den;
    return 1;
}

// pull next decoded payload.
// returns 1 = audio (abuf filled, *a_n frames), 2 = video (y/u/v filled),
//         0 = end of stream, <0 = error
int avshim_media_read(void* h, int16_t* abuf, int a_cap_frames, int* a_n,
                      int64_t* a_pts, uint8_t* ybuf, uint8_t* ubuf,
                      uint8_t* vbuf, int v_cap_pixels, int* vw, int* vh,
                      int64_t* v_pts) {
    Media* m = (Media*)h;
    while (true) {
        // 1. try draining decoders
        if (m->adec && !m->a_eof) {
            int rc = avcodec_receive_frame(m->adec, m->frame);
            if (rc == 0) {
                if (!m->swr) {
                    swr_alloc_set_opts2(&m->swr, &m->adec->ch_layout,
                                        AV_SAMPLE_FMT_S16, m->adec->sample_rate,
                                        &m->adec->ch_layout,
                                        (AVSampleFormat)m->frame->format,
                                        m->adec->sample_rate, 0, nullptr);
                    swr_init(m->swr);
                }
                int n = m->frame->nb_samples;
                if (n > a_cap_frames) n = a_cap_frames;
                uint8_t* out[1] = {(uint8_t*)abuf};
                *a_n = swr_convert(m->swr, out, n,
                                   (const uint8_t**)m->frame->data,
                                   m->frame->nb_samples);
                *a_pts = m->frame->pts;
                av_frame_unref(m->frame);
                return 1;
            }
            if (rc == AVERROR_EOF) m->a_eof = true;
        }
        if (m->vdec && !m->v_eof) {
            int rc = avcodec_receive_frame(m->vdec, m->frame);
            if (rc == 0) {
                if (m->frame->width * m->frame->height > v_cap_pixels) {
                    av_frame_unref(m->frame);
                    return -2000 - m->frame->width;
                }
                convert_to_yuv420(&m->sws, m->frame, ybuf, ubuf, vbuf, vw, vh);
                *v_pts = m->frame->pts;
                av_frame_unref(m->frame);
                return 2;
            }
            if (rc == AVERROR_EOF) m->v_eof = true;
        }
        if (m->a_eof && m->v_eof) return 0;
        if (m->draining) continue;  // decoders not yet fully drained

        // 2. feed the demuxer
        int rc = av_read_frame(m->fmt, m->pkt);
        if (rc < 0) {
            m->draining = true;
            if (m->adec) avcodec_send_packet(m->adec, nullptr);
            if (m->vdec) avcodec_send_packet(m->vdec, nullptr);
            continue;
        }
        if (m->pkt->stream_index == m->a_idx && m->adec)
            avcodec_send_packet(m->adec, m->pkt);
        else if (m->pkt->stream_index == m->v_idx && m->vdec)
            avcodec_send_packet(m->vdec, m->pkt);
        av_packet_unref(m->pkt);
    }
}

int avshim_media_seek_start(void* h) {
    Media* m = (Media*)h;
    int rc = av_seek_frame(m->fmt, -1, 0, AVSEEK_FLAG_BACKWARD);
    if (m->adec) avcodec_flush_buffers(m->adec);
    if (m->vdec) avcodec_flush_buffers(m->vdec);
    m->draining = false;
    m->a_eof = m->a_idx < 0;
    m->v_eof = m->v_idx < 0;
    return rc;
}

void avshim_media_close(void* h) {
    Media* m = (Media*)h;
    if (m->adec) avcodec_free_context(&m->adec);
    if (m->vdec) avcodec_free_context(&m->vdec);
    av_frame_free(&m->frame);
    av_packet_free(&m->pkt);
    if (m->swr) swr_free(&m->swr);
    if (m->sws) sws_freeContext(m->sws);
    avformat_close_input(&m->fmt);
    media_free_avio(m);
    delete m;
}

int avshim_have_encoder(const char* name) {
    return avcodec_find_encoder_by_name(name) != nullptr;
}

int avshim_have_decoder(const char* name) {
    return avcodec_find_decoder_by_name(name) != nullptr;
}

}  // extern "C"
