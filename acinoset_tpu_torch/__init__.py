"""PyTorch/CUDA port of acinoset_tpu, beside the JAX package.

The subpackages mirror ``acinoset_tpu`` (``ops models solvers kernels
pipeline calib eval utils parallel gui``) so each function has an
obvious counterpart.
The port imports torch, numpy and scipy only — never JAX, nor any module
of the JAX package, nor the JAX package's I/O stack (h5py, imageio,
pandas, cv2, matplotlib): it reads and writes DLC ``.h5`` files with its
own HDF5 subset (``utils.hdf5``), reads video metadata from the MP4
boxes (``utils.mp4``) and decodes and encodes mp4v video with its own
codec (``utils.mpeg4``). Tests hold every ported function to its JAX
counterpart on the same inputs.

Entry points (``solvers.trajopt.fte_solve``, ``pipeline.fte.fte_run``,
``pipeline.fte.initial_trajectory_batch``, the sweep's stages
``pipeline.sweep.solve_batch`` and ``solve_batch_ekf``, for generic
skeletons (``models.skeleton``) ``pipeline.generic.fte_generic_run``,
``pipeline.sweep.solve_batch_generic`` and ``solve_batch_ekf_generic``,
the SBA reconstruction ``pipeline.sba.sba_run``, and camera calibration
(``calib.intrinsics.calibrate_fisheye_camera`` and ``calibrate_camera``,
``calib.extrinsics.calibrate_pair_extrinsics_fisheye``,
``calibrate_pair_extrinsics``, ``calibrate_pairwise_extrinsics``,
``prepare_calib_board_data`` and
``bundle_adjust_board_points_and_extrinsics``), the file level on run
directories (``pipeline.tri.tri``, ``pipeline.sba.sba``,
``pipeline.ekf.ekf``, ``pipeline.fte.fte``, ``pipeline.sweep.sweep`` and
``sweep_generic``, ``pipeline.generic.build_and_solve``,
``pipeline.points2d.estimate_part_path``, ``eval.metrics``), the video
functions (``pipeline.video``'s, ``pipeline.plots.animate_reconstruction``,
``utils.mpeg4.Reader`` and ``Writer``), the command line ``cli`` and
``entry.entry``) run on ``cuda`` unless
the caller passes ``device="cpu"``, and raise when no device is given
and no CUDA device exists. The sweep's batched stages and
``parallel.mesh.sharded_fte_solver`` run over a device mesh, by default
every visible CUDA device. The solvers of ``solvers.lm`` and the ops
run where their tensors are. The banded-Cholesky kernel wrapper
(``kernels.banded_cuda.banded_solve``) launches its CUDA kernel on CUDA
tensors and runs its plain PyTorch version on CPU tensors.
"""
