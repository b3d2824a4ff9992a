from rat_tpu_torch.cli.run_expid import main
if __name__ == "__main__":
    main()
