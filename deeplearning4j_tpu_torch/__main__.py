from deeplearning4j_tpu_torch.cli import main

raise SystemExit(main())
