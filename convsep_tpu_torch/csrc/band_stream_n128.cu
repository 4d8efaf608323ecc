// The streamed band decode's instances of widths 72-128
// (band_stream.cuh; launched by band_stream.cu::band_stream_launch).

#include "band_stream.cuh"

BAND_STREAM_INSTANCES(launch_n128, 64)
