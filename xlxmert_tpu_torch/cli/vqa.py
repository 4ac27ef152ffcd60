"""vqa finetune/eval CLI (reference tasks/vqa.py __main__)."""
from xlxmert_tpu_torch.cli.finetune import run


def main(argv=None):
    run("vqa", argv)


if __name__ == "__main__":
    main()
