/* C inference API of paddle_tpu_torch (the declarations of
 * capi/paddle_tpu_torch_c.cpp).
 *
 * Link against libpaddle_tpu_torch_c.so (paddle_tpu_torch.capi.build()
 * compiles it; paddle_tpu_torch.sysconfig.get_lib() returns its
 * directory, paddle_tpu_torch.capi.host_link_args() the whole link line).
 * The library embeds a CPython interpreter running paddle_tpu_torch; every
 * entry point takes the interpreter lock itself.
 */
#ifndef PADDLE_TPU_TORCH_C_H_
#define PADDLE_TPU_TORCH_C_H_

#ifdef __cplusplus
extern "C" {
#endif

/* Start the embedded runtime. extra_sys_paths: ':'-separated directories
 * prepended to sys.path (paddle_tpu_torch.capi.embed_sys_paths()), or
 * NULL. Returns 0 on success. */
int PD_Init(const char* extra_sys_paths);

/* Version string of the C API (static storage; do not free). */
const char* PD_GetVersion(void);

/* Load a jit.save artifact (<prefix>.pdmodel.pt2, .pdiparams.npz,
 * .pdmodel.json) on the card. Returns an opaque handle, or NULL. */
void* PD_PredictorCreate(const char* model_prefix);

/* The same on `device`: "cpu", "cuda" or "cuda:<id>" (NULL is the card). */
void* PD_PredictorCreateOnDevice(const char* model_prefix,
                                 const char* device);

/* Run the predictor on a float32 input of the given shape.
 * Returns 0 on success (output in out/out_shape, out_shape holds at most
 * 8 dimensions); a POSITIVE value is the required out_capacity (grow the
 * buffer and call again); negative is an error (details on stderr). */
long long PD_PredictorRunFloat(void* handle, const float* data,
                               const long long* shape, int ndim, float* out,
                               long long out_capacity, long long* out_shape,
                               int* out_ndim);

/* Release a predictor handle. */
void PD_PredictorDestroy(void* handle);

/* Shut down the embedded runtime. PD_Init afterwards is unsupported. */
void PD_Finalize(void);

#ifdef __cplusplus
}  /* extern "C" */
#endif

#endif  /* PADDLE_TPU_TORCH_C_H_ */
